"""Where the device time of serving steps goes, by torch.profiler.

The port's counterpart of the JAX package's `tools/profile_step.py` (which
parses a TPU xplane trace): it runs torch.profiler over `--steps`
consecutive DDIM denoising steps of `Config()` (16 views at 256^2, bf16,
CFG 2.0, seeded weights cast for serving, the flagship-shaped synthetic
batch) after a warm-up, and prints the device's busy time, its idle share
of the unprofiled steps, and the device time by kernel group (the port's
kernels by their symbols, SDPA, cuDNN convolutions, cuBLAS, grid_sample,
norms, the optimizer, the rest) and by kernel name.

    python -m morphablediffusion_torch.tools.profile_step [--steps 3] [--top 40] [--raw]
        [--device cpu]

`chip_smoke.py` phase 5 (one step) and its training and W8A8 phases use
`profile_report` from here. On the CPU the profiler sees no device
activity and the report raises.
"""

from __future__ import annotations

import argparse
import time

import torch


def device_events(prof):
    """The device activities of a torch.profiler run: kernels, copies and
    sets, without the device-side spans of user annotations (such as
    `Optimizer.step#AdamW.step`), which overlap the kernels inside them."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_group(name: str) -> str:
    """The profiler's group of a device kernel: the port's kernels by their
    own symbols, then the kernels of PyTorch's SDPA (its flash
    `pytorch_flash::...`, memory-efficient `fmha_...` or cuDNN `..._sdpa_...`
    backends), then the library groups."""
    low = name.lower()
    for key, group in (("md_ctx_wgmma_kernel", "K1 depth_attention_ctx (wgmma)"),
                       ("md_ctx_cluster_kernel", "K1 depth_attention_ctx (cluster)"),
                       ("depth_ctx_kernel", "K1 depth_attention_ctx (WMMA)"),
                       ("md_flash_fwd_kernel", "K2 flash_attention"),
                       ("md_flash_bwd_dkv_kernel", "K2-dkv flash_attention_bwd"),
                       ("md_flash_bwd_dq_kernel", "K2-dq flash_attention_bwd"),
                       ("md_depth_attn_kernel", "K3 depth_attention"),
                       ("md_group_norm_kernel", "K4 group_norm")):
        if key in name:
            return group
    if any(w in low for w in ("pytorch_flash", "fmha", "sdpa", "attention")):
        return "SDPA (PyTorch)"
    if any(w in low for w in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "matmul", "cublas")):
        return "matmul (cuBLAS)"
    if "grid_sampler" in low:
        return "grid_sample"
    if "reduce" in low or "norm" in low:
        return "reductions and norms"
    if any(w in low for w in ("adam", "foreach", "multi_tensor_apply")):
        return "optimizer (AdamW)"
    return "elementwise and other"


def profile_report(label: str, step, top: int = 15, raw: bool = False):
    """Run step() once as a warm-up, once unprofiled and once under
    torch.profiler; print the device's busy and idle share of the
    unprofiled step and its kernel time by group and by name (every name
    with raw). Returns the profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_events(prof)
    if not kern:
        raise AssertionError("torch.profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    by_group, by_name = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us() / 1e3
        gname = kernel_group(e.name)
        by_group[gname] = by_group.get(gname, 0.0) + us
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
    # the profiler slows the host, not the device: idle share is taken
    # against the unprofiled step
    print(f"{label}: {plain_wall * 1e3:.2f} ms unprofiled, "
          f"{wall * 1e3:.2f} ms profiled; device busy {busy:.2f} ms over a "
          f"{span:.2f} ms device span; idle share of the unprofiled step "
          f"{1 - busy / (plain_wall * 1e3):.3f}; {len(kern)} device activities", flush=True)
    for gname, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms {ms / busy:6.1%}  {gname}", flush=True)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, c) in rows[:top]:
        print(f"  {ms:9.3f} ms x{c:<4d} {name[:110]}", flush=True)
    if raw:
        for name, (ms, c) in rows:
            print(f"RAW {ms:.6f} {c} {name}", flush=True)
    return prof


def profile_step(sampler, batch, index: int = 25, steps: int = 1, top: int = 15,
                 raw: bool = False, label: str = "phase 5 one denoising step"):
    """torch.profiler over `steps` consecutive denoising steps
    (predict_eps_cfg and ddim_step) from DDIM index `index` down, after a
    warm-up; see `profile_report`. Returns the profiler."""
    from morphablediffusion_torch.ops import schedules

    model = sampler.model
    m, dev = model.cfg, model.device
    g = torch.Generator(dev).manual_seed(5)
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    x0, noise = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    ts = [torch.full((1,), int(sampler.timesteps[i]), dtype=torch.int64, device=dev)
          for i in range(index, index - steps, -1)]

    def run():
        x = x0
        for i, t in zip(range(index, index - steps, -1), ts):
            eps = model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                        prep["v_embed"], batch, m.cfg_scale)
            x = schedules.ddim_step(x, eps, i, sampler.ddim, noise)
        return x

    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        return profile_report(label, run, top=top, raw=raw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--raw", action="store_true", help="print every kernel row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    args = ap.parse_args(argv)

    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.tools.common import device_line, flagship_batch
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.weights import cast_for_serving, seeded_params

    device = resolve_device(args.device)
    cfg = Config()
    model = cast_for_serving(seeded_params(
        MorphableDiffusion(cfg.model, device=device), args.seed)).eval()
    sampler = SyncDDIMSampler(model, sample_steps=cfg.model.sample_steps)
    batch = flagship_batch(cfg, device, seed=args.seed)
    print(f"# {device_line(device)}", flush=True)
    index = min(25 + args.steps // 2, cfg.model.sample_steps - 1)
    return profile_step(sampler, batch, index=index, steps=args.steps, top=args.top,
                        raw=args.raw, label=f"{args.steps} denoising steps from index {index}")


if __name__ == "__main__":
    main()
