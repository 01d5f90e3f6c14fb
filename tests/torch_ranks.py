"""Spawning the PyTorch port's ranks on the CPU for the parallel tests
(tests/test_torch_parallel_*.py).

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes (spawn,
so no JAX state is forked), each calling fn(mesh, *args) on a gloo mesh
initialised through a file under tmp_path (no TCP ports, so tests running
side by side cannot race for one) with one torch thread. It fails if a rank
raises or has not ended within `timeout` seconds (then every rank is
killed): a hung collective fails the test in seconds instead of using up
the suite's clock. This module imports only torch and the port, which is
all a rank imports.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import traceback

import torch

JOIN_TIMEOUT = 180.0


def _rank_main(rank, world, init_file, fn, args, errors):
    torch.set_num_threads(1)
    from morphablediffusion_torch.parallel import close_mesh, create_mesh

    mesh = create_mesh("gloo", "cpu", rank=rank, world=world,
                       init_method=f"file://{init_file}")
    try:
        fn(mesh, *args)
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise
    finally:
        close_mesh(mesh)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT) -> None:
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    init_file = tmp_path / f"init_{world}_{fn.__name__}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(init_file), fn, args, errors))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                raise AssertionError(f"a rank of {world} did not end within {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        msgs = []
        while not errors.empty():
            msgs.append("rank %d:\n%s" % errors.get())
        raise AssertionError(f"ranks failed (rank, exit code) {failed}\n" + "\n".join(msgs))


def _model(p):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion

    cfg = p["cfg"]
    model = MorphableDiffusion(getattr(cfg, "model", cfg), device="cpu")
    model.load_state_dict(p["state"], strict=True)
    return model


def sampling_rank(mesh, payload: str, out: str) -> None:
    """The view-parallel sampler on this rank: denoise with the trajectory,
    then sample (denoise + decode), on the payload's model, batch and
    injected noise; saves the gathered latents, trajectory and images and
    every spatial volume the rank built to out/rank<r>.pt."""
    from morphablediffusion_torch.sampling import SyncDDIMSampler

    p = torch.load(payload, weights_only=False)
    model = _model(p).eval()
    volumes = []
    build = model.spatial_volume.construct_spatial_volume

    def record(*a, **k):
        v = build(*a, **k)
        volumes.append(v.clone())
        return v

    model.spatial_volume.construct_spatial_volume = record
    sampler = SyncDDIMSampler(model, sample_steps=p["steps"], batch_view_num=p["bvn"],
                              mesh=mesh)
    batch, kw = p["batch"], dict(x_init=p["x_init"], noises=p["noises"])
    prep = model.prepare_inference(batch)
    latents, traj = sampler.denoise_latents(batch, prep, 2.0, collect_trajectory=True, **kw)
    images, latents2 = sampler.sample(batch, 2.0, **kw)
    torch.save(dict(latents=latents, traj=traj, images=images, latents2=latents2,
                    volumes=volumes), f"{out}/rank{mesh.rank}.pt")


def params_digest(named) -> str:
    """A digest of the parameters' bytes: two ranks' parameters are equal to
    the bit when their digests are."""
    h = hashlib.sha256()
    for n, p in named:
        h.update(n.encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def training_rank(mesh, payload: str, out: str) -> None:
    """Data-parallel Trainer steps on this rank: the payload's model and
    config (AdamW eps `eps`), optionally a checkpoint state to resume from,
    this rank's rows of the global batch, one train_step per entry of the
    global `draws`. Saves to out/rank<r>.pt the metrics, the moment
    elements held and the parameters' digest; rank 0 also the parameters
    and, with `save_state`, the gathered state_dict (every rank gathers)."""
    from morphablediffusion_torch.parallel import shard_batch
    from morphablediffusion_torch.training import trainer as t_trainer

    p = torch.load(payload, weights_only=False)
    t_trainer.EPS = p["eps"]
    tr = t_trainer.Trainer(p["cfg"], model=_model(p), mesh=mesh)
    if p.get("resume") is not None:
        tr.load_state_dict(torch.load(p["resume"], weights_only=False))
    batch = shard_batch(p["batch"], mesh)
    metrics = [tr.train_step(batch, draws=d) for d in p["draws"]]
    state = tr.state_dict() if p.get("save_state") else None
    res = dict(metrics=metrics, moments=tr.zero.moment_elements(), step=tr.step,
               opt_step=tr.opt_step, digest=params_digest(tr.model.named_parameters()))
    if mesh.rank == 0:
        res.update(params={n: q.detach() for n, q in tr.model.named_parameters()},
                   state=state)
    torch.save(res, f"{out}/rank{mesh.rank}.pt")
