"""Full-trajectory W8A8 quality evidence at flagship width.

The port's counterpart of the repository's `tools/int8_trajectory.py`. It
runs the complete 50-step 16-view CFG DDIM reverse process twice with the
same weights and the same noise stream (a `torch.Generator` seeded with
`--seed`): once with bf16 convs, once with W8A8 int8 serving
(`cfg.model.unet.w8a8`, ops/int8.py), and records

  * the per-step relative L2 drift between the two latent trajectories
    (the quantization error as it propagates through the whole process);
  * the PSNR and the largest absolute difference between the two final
    decoded image stacks (clipped to [-1, 1]), the quantity the serving
    mode must preserve;

under the JAX tool's JSON keys (sample_steps, seed, per_step_rel_l2,
final_rel_l2, final_image_psnr_bf16_vs_w8a8, final_image_max_abs). The
weights come from a reference-named checkpoint through the port's importer
(`tools/make_flagship_ckpt.py` writes one), or from a checkpoint directory:
a JAX run's (its Orbax params export, read without JAX), the port's, or an
Orbax params tree itself such as the JAX tool's `--native_cache`; `--ckpt
random` takes seeded weights (seed 0).

    python -m morphablediffusion_torch.tools.int8_trajectory --ckpt flagship.ckpt|RUN/ckpt \
        [--out int8_trajectory.json] [--sample_steps 50] [--seed 7] [--device cpu]

`--out` defaults to the working directory.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch


def load_model(cfg, ckpt: str, device):
    """The serving model of `cfg` (bf16 weights, fp32 norms) on `device`,
    its weights from a reference-named checkpoint or a checkpoint directory
    (`utils.checkpoint.load_params_dir`), or seeded (seed 0) for ckpt
    'random'."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.utils.checkpoint import load_params_dir
    from morphablediffusion_torch.utils.torch_import import import_torch_checkpoint
    from morphablediffusion_torch.weights import cast_for_serving, seeded_params

    model = MorphableDiffusion(cfg.model, device=device)
    if ckpt == "random":
        seeded_params(model, 0)
    elif Path(ckpt).is_dir():
        load_params_dir(model, ckpt)
    else:
        report = import_torch_checkpoint(ckpt, model)
        if report["unused_torch_keys"] or report["unmatched_model_paths"]:
            raise ValueError(f"{ckpt}: import report {report}")
    return cast_for_serving(model).eval()


def trajectory(model, batch, seed: int, sample_steps: int, x_init=None, noises=None):
    """One CFG reverse process: (every post-update latent stacked (S, B, N,
    h, w, 4) fp64 on the host, the decoded images clipped to [-1, 1] fp64
    on the host, seconds by CUDA events or the host clock). The noise comes
    from a generator seeded with `seed` unless x_init and noises are given."""
    from morphablediffusion_torch.sampling import SyncDDIMSampler

    dev = model.device
    sampler = SyncDDIMSampler(model, sample_steps=sample_steps)
    gen = torch.Generator(dev).manual_seed(seed)
    cuda = dev.type == "cuda"
    if cuda:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        _, traj = sampler.denoise_latents(batch, prep, model.cfg.cfg_scale, generator=gen,
                                          x_init=x_init, noises=noises,
                                          collect_trajectory=True)
        images = model.decode_views(traj[-1]).clamp(-1, 1).double().cpu()
    if cuda:
        ev1.record()
        torch.cuda.synchronize()
        seconds = ev0.elapsed_time(ev1) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return torch.stack(traj).double().cpu(), images, seconds


def drift_report(trajs, images, sample_steps: int, seed: int) -> dict:
    """The JAX tool's numbers from the two runs' trajectories and images
    ({"bf16": .., "w8a8": ..})."""
    a, b = (np.asarray(trajs[k], np.float64) for k in ("bf16", "w8a8"))
    denom = np.sqrt((a.reshape(len(a), -1) ** 2).mean(axis=1))
    drift = np.sqrt(((a - b).reshape(len(a), -1) ** 2).mean(axis=1)) / denom
    ia, ib = (np.clip(np.asarray(images[k], np.float64), -1, 1) for k in ("bf16", "w8a8"))
    mse = float(((ia - ib) ** 2).mean())
    return {"sample_steps": sample_steps, "seed": seed,
            "per_step_rel_l2": [round(float(d), 5) for d in drift],
            "final_rel_l2": float(drift[-1]),
            "final_image_psnr_bf16_vs_w8a8": float(10 * np.log10(4.0 / mse)),
            "final_image_max_abs": float(np.abs(ia - ib).max())}


def run(cfg, ckpt: str, device, sample_steps: int = 50, seed: int = 7, batch=None):
    """Both runs on the same weights and noise -> (report, seconds by mode).
    `batch` defaults to the flagship-shaped synthetic batch of `cfg`."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.tools.common import flagship_batch
    from morphablediffusion_torch.weights import cast_for_serving

    cfg8 = copy.deepcopy(cfg)
    cfg8.model.unet.w8a8 = True
    if batch is None:
        batch = flagship_batch(cfg, device, seed=0)
    trajs, images, seconds = {}, {}, {}
    model = load_model(cfg, ckpt, device)
    trajs["bf16"], images["bf16"], seconds["bf16"] = trajectory(model, batch, seed,
                                                                sample_steps)
    # the same weights (read once) in the W8A8 model
    w8a8 = MorphableDiffusion(cfg8.model, device=device)
    w8a8.load_state_dict(model.state_dict(), strict=True)
    del model
    cast_for_serving(w8a8).eval()
    trajs["w8a8"], images["w8a8"], seconds["w8a8"] = trajectory(w8a8, batch, seed,
                                                                sample_steps)
    return drift_report(trajs, images, sample_steps, seed), seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="int8_trajectory.json")
    ap.add_argument("--ckpt", required=True,
                    help="reference-named .ckpt/.pt (tools/make_flagship_ckpt.py), a "
                         "checkpoint directory (a JAX run's, the port's, or an Orbax params "
                         "tree such as the JAX tool's --native_cache), or 'random'")
    ap.add_argument("--sample_steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    args = ap.parse_args(argv)

    from morphablediffusion_torch.tools.common import device_line
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import Config

    device = resolve_device(args.device)
    results, seconds = run(Config(), args.ckpt, device, args.sample_steps, args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(json.dumps({k: v for k, v in results.items() if k != "per_step_rel_l2"}))
    print(f"# avatars (denoise and decode): bf16 {seconds['bf16']:.3f} s, W8A8 "
          f"{seconds['w8a8']:.3f} s on {device_line(device)}")
    print(f"-> {out}")
    return results


if __name__ == "__main__":
    main()
