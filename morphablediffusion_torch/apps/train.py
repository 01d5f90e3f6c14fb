"""Training CLI of the PyTorch port.

Counterpart of the JAX package's `apps/train.py`: flags -b/-l/-n/-s/--resume/
--max_steps/--profile_steps/--finetune_from/--vae_from/--rss_restart_gb, the
FaceScape and THuman datasets, the step log line (with the host's RSS and
the caching allocator's cudaMalloc / cudaFree calls and retries since the
previous line, `utils/spans.py::counters`),
TensorBoard scalars where `torch.utils.tensorboard` imports, a validation
contact sheet every `val_check_interval` steps (the DDIM sampler with the
config's `batch_view_num`), rolling and snapshot checkpoints, the refusal to
overwrite an existing run, and the final checkpoint. `--device cpu` runs it
on the CPU (a rehearsal at a tiny config).

    python -m morphablediffusion_torch.apps.train -b configs/facescape.yaml \
        -l runs -n facescape [--resume] [--device cpu]

Data parallel over N ranks (one process a card; `data.batch_size` is per
rank, ZeRO-1 with `train.shard_opt_state`): start it with torchrun,

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m morphablediffusion_torch.apps.train -b ... [--dist_backend nccl|gloo]

Rank 0 alone logs, writes TensorBoard, renders the validation sheet and
writes the checkpoints; the other ranks wait for it at a barrier.
--rss_restart_gb is refused on more than one rank (a joint re-exec of the
ranks under torchrun is not supported).

--vae_from grafts a `train_vae` file into the frozen first stage, and
--finetune_from then imports a reference checkpoint (`utils/torch_import.py`)
over the seeded weights, both before step 0; both are ignored on --resume,
whose checkpoint supersedes them. --resume also continues a run of the JAX
package's train CLI: where `<logdir>/<name>/ckpt/last/` holds an Orbax
TrainState and no port checkpoint, its step, parameters, AdamW moments and
gradient accumulator are read without JAX (`utils/checkpoint.py::
jax_train_state`); its threefry key cannot become a torch.Generator state, so
the generator is seeded from (seed, step). From then on the port writes its
own checkpoints beside JAX's step directories and resumes from them.
--rss_restart_gb N: at a rolling-checkpoint
step before the last, if the host RSS exceeds N GiB, the process replaces
itself (`os.execv`) with the same command plus --resume.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def build_datasets(cfg):
    """(train, val) datasets of the config: FaceScape or THuman."""
    from morphablediffusion_torch.data import facescape, thuman

    d, m = cfg.data, cfg.model
    if d.dataset == "facescape":
        train_ids, val_ids = facescape.train_val_uids()
        extra = {"flame_assets_dir": d.flame_assets_dir} if d.flame_assets_dir else {}
        mk = lambda ids, seed: facescape.FaceScapeDataset(
            d.data_dir, ids, mesh_topology=d.mesh_topology,
            shuffled_expression=d.shuffled_expression, image_size=m.image_size,
            num_views=m.view_num, max_vertices=m.max_vertices, seed=seed, **extra)
    elif d.dataset == "thuman":
        train_ids, val_ids = thuman.train_val_uids()
        mk = lambda ids, seed: thuman.THumanDataset(
            d.data_dir, d.smplx_dir, ids, image_size=m.image_size, num_views=m.view_num,
            max_vertices=m.max_vertices, seed=seed)
    else:
        raise NotImplementedError(d.dataset)
    if d.uids:
        train_ids = list(d.uids)
    if d.val_uids:
        val_ids = list(d.val_uids)
    return mk(train_ids, d.seed), mk(val_ids, d.seed + 1)


def rss_gib() -> float:
    """The host's resident set size of this process in GiB (0 where
    /proc is absent)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096 / 2**30
    except OSError:
        return 0.0


@torch.no_grad()
def graft_vae(model, path: str) -> None:
    """Load a `train_vae` file into model.first_stage, in the dtype of each
    parameter there; refuse a file of another architecture."""
    from morphablediffusion_torch.apps.train_vae import load_vae

    state, meta = load_vae(path)
    print(f"grafting first_stage from {path} ({meta})")
    like = model.first_stage.state_dict()
    if state.keys() != like.keys() or any(state[k].shape != v.shape for k, v in like.items()):
        raise ValueError("VAE arch mismatch: config vae_ch/vae_ch_mult/vae_num_res_blocks "
                         "must match the train_vae run")
    for k, v in like.items():
        v.copy_(state[k].to(v.dtype))


def save_val_sheet(images, batch, path):
    """Contact sheet: one row per sample, input | generated views."""
    from PIL import Image

    to8 = lambda x: ((np.clip(np.asarray(x), -1, 1) + 1) * 127.5).astype(np.uint8)
    rows = []
    for b in range(images.shape[0]):
        tiles = [to8(batch["input_image"][b])] + [to8(images[b, n])
                                                  for n in range(images.shape[1])]
        rows.append(np.concatenate(tiles, axis=1))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.concatenate(rows, axis=0)).save(path)


def to_device(batch, device):
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in batch.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-b", "--base", type=str, required=True, help="config yaml")
    parser.add_argument("-l", "--logdir", type=str, default="runs")
    parser.add_argument("-n", "--name", type=str, default="run")
    parser.add_argument("-s", "--seed", type=int, default=6033)
    parser.add_argument("--resume", action="store_true",
                        help="continue the run: the port's checkpoint, else the JAX "
                             "train CLI's Orbax TrainState in the same ckpt directory")
    parser.add_argument("--max_steps", type=int, default=0, help="override config")
    parser.add_argument("--profile_steps", type=str, default="",
                        help="trace steps with torch.profiler, e.g. '10-15'")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    parser.add_argument("--finetune_from", type=str, default="",
                        help="reference .ckpt/.pt/.pth to start from (ignored on --resume)")
    parser.add_argument("--vae_from", type=str, default="",
                        help="a train_vae file (the port's .pt or the JAX CLI's .msgpack) "
                             "grafted into the frozen first_stage before step 0 (ignored "
                             "on --resume)")
    parser.add_argument("--rss_restart_gb", type=float, default=0.0,
                        help="restart with --resume (os.execv) when the host RSS exceeds this "
                             "many GiB at a rolling-checkpoint step; 0 = off")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="under torchrun: the process group's backend (default nccl on "
                             "the card, gloo on the CPU)")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.data.loader import PrefetchLoader
    from morphablediffusion_torch.parallel import close_mesh, create_mesh
    from morphablediffusion_torch.parallel.collectives import barrier
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils import spans
    from morphablediffusion_torch.utils.checkpoint import CheckpointManager
    from morphablediffusion_torch.utils.config import load_config

    cfg = load_config(flags.base)
    cfg.train.seed = flags.seed
    if flags.max_steps:
        cfg.train.max_steps = flags.max_steps
    mesh = create_mesh(flags.dist_backend, flags.device)
    device, rank0 = mesh.device, mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    if flags.rss_restart_gb and mesh.world > 1:
        close_mesh(mesh)
        raise ValueError("--rss_restart_gb runs on one rank only: the ranks under torchrun "
                         "cannot re-exec together")

    run_dir = Path(flags.logdir) / flags.name
    ckpt = CheckpointManager(run_dir / "ckpt", rolling_every=cfg.train.rolling_checkpoint_every,
                             snapshot_every=cfg.train.checkpoint_every, mesh=mesh)
    ckpt.assert_fresh_or_resume(flags.resume)

    train_ds, val_ds = build_datasets(cfg)
    trainer = Trainer(cfg, device=device, mesh=mesh)
    if flags.resume and ckpt.latest_step() is not None:
        say(f"resumed from step {ckpt.restore(trainer)}")
    else:
        if flags.vae_from:
            graft_vae(trainer.model, flags.vae_from)
        if flags.finetune_from:
            from morphablediffusion_torch.utils.torch_import import import_torch_checkpoint

            import_torch_checkpoint(flags.finetune_from, trainer.model)
    loader = PrefetchLoader(train_ds, cfg.data.batch_size, seed=cfg.data.seed,
                            num_workers=cfg.data.num_workers, process_index=mesh.rank,
                            process_count=mesh.world)
    val_loader = PrefetchLoader(val_ds, cfg.model.output_num, shuffle=False,
                                num_workers=cfg.data.num_workers)
    prof_lo = prof_hi = -1
    if flags.profile_steps:
        lo, _, hi = flags.profile_steps.partition("-")
        prof_lo, prof_hi = int(lo), int(hi or lo)

    writer = None
    if rank0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(str(run_dir / "tb"))
        except Exception:  # TensorBoard is optional, as in the JAX package
            writer = None
    batches = loader.epochs()
    sampler = val_batches = prof = None
    t_last = time.perf_counter()
    alloc_last = spans.counters(device)
    try:
        while trainer.step < cfg.train.max_steps:
            if trainer.step == prof_lo and rank0:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
            metrics = trainer.train_step(to_device(next(batches), device))
            step = metrics["step"] + 1
            if prof is not None and step - 1 == prof_hi:
                prof.__exit__(None, None, None)
                path = run_dir / "profile" / f"steps_{prof_lo}-{prof_hi}.json"
                path.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(path))
                prof = None
                say(f"profiler trace written to {path}")

            if step % cfg.train.log_every == 0:
                loss = float(metrics["loss"])
                dt = (time.perf_counter() - t_last) / cfg.train.log_every
                t_last = time.perf_counter()
                mem = (torch.cuda.max_memory_allocated(device) / 2**30
                       if device.type == "cuda" else 0.0)
                lr = trainer.lr_at(trainer.opt_step)
                grad_norm = float(metrics["grad_norm"])
                alloc = spans.counters(device)  # the caching allocator since the last line
                churn = {k: v - alloc_last[k] for k, v in alloc.items()}
                alloc_last = alloc
                say(f"step {step} loss {loss:.4f} grad_norm {grad_norm:.4f} lr {lr:.2e} "
                      f"{dt * 1000:.0f} ms/step peak {mem:.1f} GiB rss {rss_gib():.1f} GiB "
                      f"cudaMalloc {churn['cuda_malloc']} cudaFree {churn['cuda_free']} "
                      f"retries {churn['alloc_retries']}", flush=True)
                if writer:
                    for tag, value in (("loss", loss), ("step_time_s", dt),
                                       ("grad_norm", grad_norm), ("hbm_gib", mem), ("lr", lr)):
                        writer.add_scalar(f"train/{tag}", value, step)

            if (cfg.train.val_check_interval and step % cfg.train.val_check_interval == 0
                    and rank0):
                if sampler is None:
                    sampler = SyncDDIMSampler(trainer.model, cfg.model.sample_steps,
                                              batch_view_num=cfg.model.batch_view_num)
                    val_batches = val_loader.epochs()
                val_batch = to_device(next(val_batches), device)
                gen = torch.Generator(device).manual_seed(step)
                images, _ = sampler.sample(val_batch, cfg.model.cfg_scale, generator=gen)
                save_val_sheet(images.cpu().numpy(), {k: v.cpu().numpy()
                                                      for k, v in val_batch.items()},
                               run_dir / "images" / "val" / f"{step}.jpg")
            if cfg.train.val_check_interval and step % cfg.train.val_check_interval == 0:
                barrier(mesh)  # the other ranks wait for rank 0's validation
            ckpt.maybe_save(trainer, step)
            if (flags.rss_restart_gb and step % max(cfg.train.rolling_checkpoint_every, 1) == 0
                    and step < cfg.train.max_steps):
                rss = rss_gib()
                if rss > flags.rss_restart_gb:
                    # the rolling checkpoint of this step is saved: replace the
                    # process image and resume from it
                    if writer:
                        writer.close()
                    argv_new = list(argv if argv is not None else sys.argv[1:])
                    if "--resume" not in argv_new:
                        argv_new.append("--resume")
                    print(f"rss {rss:.1f} GiB > {flags.rss_restart_gb} GiB: self-restarting "
                          f"with --resume at step {step}", flush=True)
                    os.execv(sys.executable, [sys.executable, "-m",
                                              "morphablediffusion_torch.apps.train", *argv_new])
        ckpt.maybe_save(trainer, trainer.step, force=True)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        batches.close()  # stops the producer thread
        if val_batches is not None:
            val_batches.close()
        if writer:
            writer.close()
    close_mesh(mesh)
    say("training done")


if __name__ == "__main__":
    main()
