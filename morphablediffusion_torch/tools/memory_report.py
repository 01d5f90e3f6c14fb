"""Device memory of the train step and of the sampling step.

The port's counterpart of the repository's `tools/memory_report.py` (which
prints XLA's ahead-of-time memory analysis): the tool for checking that a
recipe fits the card before launching it, and for sizing remat and batch.
It runs the steps on the card and reads `torch.cuda.max_memory_allocated`
after `reset_peak_memory_stats`:

  * one `Trainer.train_step` at `--batch` (default the config's batch
    size) on a synthetic flagship-shaped batch, its first (so AdamW's
    moments are created inside it);
  * one CFG denoising step (`predict_eps_cfg` + `ddim_step`) at `--views`,
    seeded weights cast for serving;

and prints, as the JAX tool prints its argument and temp bytes, the bytes of
the parameters, gradients and AdamW moments by label group (frozen: VAE and
CLIP, base, cond: the conditioning nets at 10x the rate).

    python -m morphablediffusion_torch.tools.memory_report [--batch 8] [--views 16]
        [--tiny] [--no_train] [--no_sample] [--device cpu]

On the CPU the byte counts are printed and the peaks are "not measured".
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch


def fmt(n: int) -> str:
    return f"{n / 2**30:8.2f} GiB" if n >= 2**28 else f"{n / 2**20:8.1f} MiB"


def state_bytes(trainer) -> Dict[str, Dict[str, int]]:
    """{"parameters", "gradients", "adamw_moments"} -> {label: bytes}: every
    parameter by its label, the gradients of those that get one, and the
    AdamW moments (exp_avg and exp_avg_sq) the optimizer holds."""
    named = dict(trainer.model.named_parameters())
    by_param = {id(p): n for n, p in named.items()}
    out = {"parameters": {}, "gradients": {}, "adamw_moments": {}}
    add = lambda kind, label, n: out[kind].__setitem__(label, out[kind].get(label, 0) + n)
    for n, p in named.items():
        add("parameters", trainer.labels[n], p.numel() * p.element_size())
        if p.requires_grad:
            add("gradients", trainer.labels[n], p.numel() * p.element_size())
    for p, st in trainer.optimizer.state.items():
        for k, t in st.items():
            if k in ("exp_avg", "exp_avg_sq"):
                add("adamw_moments", trainer.labels[by_param[id(p)]], t.numel() * t.element_size())
    return out


def _peak(device, fn):
    """fn() once; the peak bytes allocated on the card during it (None on
    the CPU)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fn()
    if not cuda:
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def train_report(cfg, device, batch_size: int, seed: int = 0) -> dict:
    """One training step at `batch_size`: its peak and the state's bytes."""
    from morphablediffusion_torch.tools.common import flagship_batch
    from morphablediffusion_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device, seed=seed)
    batch = flagship_batch(cfg, device, seed=seed, B=batch_size, with_targets=True)
    peak = _peak(device, lambda: trainer.train_step(batch))
    report = {"batch": batch_size, "views": cfg.model.view_num,
              "remat": cfg.model.unet.use_checkpoint, "peak_bytes": peak,
              **state_bytes(trainer)}
    del trainer, batch
    return report


def sample_report(cfg, device, seed: int = 0, index: int = 25) -> dict:
    """One CFG denoising step (prepare_inference first, outside the peak)."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.ops import schedules
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.tools.common import flagship_batch
    from morphablediffusion_torch.weights import cast_for_serving, seeded_params

    m = cfg.model
    model = cast_for_serving(seeded_params(MorphableDiffusion(m, device=device), seed)).eval()
    sampler = SyncDDIMSampler(model, sample_steps=m.sample_steps)
    batch = flagship_batch(cfg, device, seed=seed)
    index = min(index, m.sample_steps - 1)
    g = torch.Generator(device).manual_seed(5)
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    x, noise = (torch.randn(shape, generator=g, device=device) for _ in range(2))
    t = torch.full((1,), int(sampler.timesteps[index]), dtype=torch.int64, device=device)
    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        peak = _peak(device, lambda: schedules.ddim_step(
            x, model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                     prep["v_embed"], batch, m.cfg_scale),
            index, sampler.ddim, noise))
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    return {"views": m.view_num, "sample_steps": m.sample_steps, "peak_bytes": peak,
            "parameter_bytes": params}


def print_report(name: str, report: dict) -> None:
    print(f"\n== {name} ==")
    peak = report["peak_bytes"]
    print(f"  {'peak':<14} {fmt(peak) if peak is not None else 'not measured (CPU)'}")
    for kind in ("parameters", "gradients", "adamw_moments"):
        for label, n in sorted(report.get(kind, {}).items()):
            print(f"  {kind:<14} {label:<7} {fmt(n)}")
    if "parameter_bytes" in report:
        print(f"  {'parameters':<14} {fmt(report['parameter_bytes'])}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=0,
                    help="train batch (default: config batch_size)")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", help="tiny shapes (fast)")
    ap.add_argument("--no_train", action="store_true")
    ap.add_argument("--no_sample", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    args = ap.parse_args(argv)

    from morphablediffusion_torch.tools.common import device_line, tiny_config
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import Config

    device = resolve_device(args.device)
    if args.tiny:
        cfg = tiny_config(view_num=min(args.views, 4))
    else:
        cfg = Config()
        cfg.model.view_num = args.views
    if args.batch:
        cfg.data.batch_size = args.batch
    print(f"# {device_line(device)}")
    result = {}
    if not args.no_train:
        B = 1 if args.tiny else max(cfg.data.batch_size, 1)
        result["train"] = train_report(cfg, device, B)
        print_report(f"train step (B={B}, N={cfg.model.view_num}, "
                     f"remat={cfg.model.unet.use_checkpoint})", result["train"])
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if not args.no_sample:
        result["sample"] = sample_report(cfg, device)
        print_report(f"sampling (one of {cfg.model.sample_steps} steps, "
                     f"N={cfg.model.view_num})", result["sample"])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
