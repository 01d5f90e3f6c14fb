#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root. It needs a CUDA card and the CUDA toolkit
(`nvcc`); without a card it exits non-zero before printing any result. It
imports nothing of JAX and nothing of the JAX package.

Phases (any failure exits non-zero):
  1. build the hand-written kernels from `morphablediffusion_torch/csrc/`
     (one nvcc per source, all started together); print the build seconds and
     the card's name and power limit as nvidia-smi gives them;
  2. hold each kernel against its plain PyTorch version at every shape the
     main path gives it, in bf16, within relative L2 1e-2, and time the
     kernel, the plain version and, for flash attention,
     F.scaled_dot_product_attention (the yardstick `library_ms`; the port
     never calls it there);
  3. one full-width `predict_eps_cfg` step with the kernels and with the
     plain versions, in bf16; print and bound the relative L2 between the
     two, and hold the kernels' step no further from the fp32 model (same
     seeded weights, plain versions) than 1.25 x the plain bf16 step;
  4. the full avatar: `Config()` defaults (16 views at 256^2, bf16, CFG 2.0,
     50 DDIM steps, coarse mesh voxels), seeded weights cast for serving; one
     warm-up run, then one timed run with every launch counter set to 0
     just before it: the depth-context kernel must launch 500 times and the
     flash kernel 250 times, and the images must be finite and not constant;
  5. profile one denoising step with torch.profiler: the device's busy and
     idle share and its kernel time by group and by name;
  6. print the kernels line, the card line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Fp32 references on the card run with TF32 off: both
`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
are set to False at start (the serving path itself runs in bf16).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

# Published dense peaks of one H100 SXM (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REL_L2_KERNEL = 1e-2  # bf16 kernel vs its plain bf16 version
REL_L2_STEP = 5e-2  # one whole bf16 CFG step, kernels vs plain versions
# the kernels' bf16 step may sit at most this much further from the fp32
# model than the plain versions' bf16 step does (both measured ~2.2e-2)
STEP_VS_FP32_RATIO = 1.25


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_batch(cfg, device, seed: int = 0):
    """Synthetic flagship-shaped batch, the JAX layout: B=1, view_num
    targets on a ring of cameras at distance 4 looking at the origin,
    image_size^2 input image, max_vertices vertices in [-0.2, 0.2]^3."""
    m = cfg.model
    rng = np.random.default_rng(seed)
    N, S, Nv = m.view_num, m.image_size, m.max_vertices
    poses = []
    for i in range(N):
        a = 2 * np.pi * i / max(N, 1) * 0.2
        R = np.asarray([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        t = -R @ (R.T @ np.asarray([0, 0, -4.0]))
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    K = np.eye(4)
    if m.projection == "perspective":
        K[:3, :3] = [[80.0, 0, S / 2], [0, 80.0, S / 2], [0, 0, 1]]
    else:
        K[0, 0] = K[1, 1] = 1 / 0.6
    verts = rng.uniform(-0.2, 0.2, size=(1, Nv, 3))  # drawn first, as bench.py's batch
    arrays = {
        "input_image": rng.uniform(-1, 1, (1, S, S, 3)),
        "input_elevation": np.zeros((1, 1)),
        "input_azimuth": np.zeros((1, 1)),
        "target_elevation": np.zeros((1, N)),
        "target_azimuth": np.zeros((1, N)),
        "target_K": np.broadcast_to(K, (1, N, 4, 4)),
        "target_RT": np.broadcast_to(np.stack(poses), (1, N, 3, 4)),
        "vertices": verts,
        "vertex_mask": np.ones((1, Nv)),
    }
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def serving_model(cfg, device, seed: int = 0):
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.weights import cast_for_serving, seeded_params

    model = MorphableDiffusion(cfg.model, device=device)
    return cast_for_serving(seeded_params(model, seed)).eval()


def main_path_shapes(cfg):
    """The shapes the main path gives each kernel, with launches per step.

    K1: every DepthTransformer of the UNet at serving; the frustum net halves
    depth with width. K2: the self-attention of the SpatialTransformers at
    ds=1 (L = latent^2 tokens), on the CFG-doubled batch."""
    from morphablediffusion_torch.models.unet import MIDDLE_COND_CTX, OUT_COND_CTX

    m, u = cfg.model, cfg.model.unet
    B, lat = m.view_num, m.latent_size
    ctx_index = [MIDDLE_COND_CTX, *OUT_COND_CTX.values()]  # width lat >> index
    k1 = []
    for i in sorted(set(ctx_index), reverse=True):
        W, Cc = lat >> i, u.volume_dims[i]
        k1.append(dict(B=B, W=W, D=m.frustum_volume_depth >> i, Cc=Cc, Ci=2 * Cc,
                       heads=4, per_step=ctx_index.count(i)))
    ds1_transformers = (2 * u.num_res_blocks + 1) if 1 in u.attention_ds else 0
    k2 = dict(B=2 * B, L=lat * lat, heads=u.num_heads,
              hd=u.model_channels // u.num_heads, per_step=ds1_transformers)
    return k1, k2


def k1_cost(s):
    """(FLOPs, bytes) the fused depth-context function needs: the Cc x Cc
    projection, k and v (Cc x Ci each), logits and weighted sum, on B*D*S
    pixels; each input read once and the output written once."""
    B, D, S, Cc, Ci = s["B"], s["D"], s["W"] ** 2, s["Cc"], s["Ci"]
    flops = 2 * B * D * S * (Cc * Cc + 2 * Cc * Ci + 2 * Ci)
    nbytes = 2 * (B * Ci * S * 2 + B * Cc * D * S + Cc * Cc + 2 * Ci * Cc) + 2 * B * Cc * 4
    return flops, nbytes


def k2_cost(s):
    B, L, H, hd = s["B"], s["L"], s["heads"], s["hd"]
    return 4 * B * H * L * L * hd, 4 * B * L * H * hd * 2


def bound_ms(flops: float, nbytes: float):
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def check_kernels(k1_shapes, k2_shape, device, iters: int = 10):
    """Phase 2: every kernel against its plain version at the main path's
    shapes, bf16. Returns {name: result} for the kernels line."""
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device).manual_seed(0)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    results = {}

    rows = []
    for s in k1_shapes:
        B, W, D, Cc, Ci, heads = s["B"], s["W"], s["D"], s["Cc"], s["Ci"], s["heads"]
        q, ctx = rn(B, Ci, W, W), rn(B, Cc, D, W, W)
        Wp, Wk, Wv = (rn(Cc, Cc, std=Cc ** -0.5), rn(Ci, Cc, std=Cc ** -0.5),
                      rn(Ci, Cc, std=Cc ** -0.5))
        mean_x, m2 = da.ctx_moments(ctx)
        A, B2 = da._ctx_affine(mean_x, m2, Wp, torch.ones(Cc, device=device),
                               torch.zeros(Cc, device=device), 8, 1e-5)
        args = (q, ctx, Wp, A, B2, Wk, Wv, heads)
        out = da.ctx_attention(*args)
        plain = da._ctx_reference(*args)
        torch.cuda.synchronize()
        err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
        ms = cuda_ms(lambda: da.ctx_attention(*args), iters)
        plain_ms = cuda_ms(lambda: da._ctx_reference(*args), max(2, iters // 4))
        flops, nbytes = k1_cost(s)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"K1 depth_attention_ctx W={W} D={D} Cc={Cc} Ci={Ci} B={B}: rel_l2={err:.3e} "
            f"max_abs={mae:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) x{s['per_step']}/step")
        if not err <= REL_L2_KERNEL:
            raise AssertionError(f"K1 at W={W}: rel L2 {err:.3e} > {REL_L2_KERNEL}")
        rows.append(dict(shape=f"W={W},D={D},Cc={Cc}", per_step=s["per_step"], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, flops=flops, bytes=nbytes,
                         rel_l2=err, max_abs_err=mae))
    results["depth_attention_ctx"] = rows

    s = k2_shape
    B, L, heads, hd = s["B"], s["L"], s["heads"], s["hd"]
    q, k, v = (rn(B, L, heads * hd) for _ in range(3))
    out = fa.flash_attention(q, k, v, heads)
    plain = fa.attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, heads), iters)
    plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v, heads), max(2, iters // 4))
    qh, kh, vh = (t.reshape(B, L, heads, hd).transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
    flops, nbytes = k2_cost(s)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"K2 flash_attention B={B} L={L} heads={heads} hd={hd}: rel_l2={err:.3e} "
        f"max_abs={mae:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) "
        f"x{s['per_step']}/step")
    if not err <= REL_L2_KERNEL:
        raise AssertionError(f"K2: rel L2 {err:.3e} > {REL_L2_KERNEL}")
    results["flash_attention"] = [dict(
        shape=f"B={B},L={L},heads={heads},hd={hd}", per_step=s["per_step"], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, flops=flops, bytes=nbytes, rel_l2=err,
        max_abs_err=mae, library_ms=lib_ms)]
    return results


@contextlib.contextmanager
def plain_versions():
    """Route both kernel wrappers to their plain versions on the card (for
    the step comparison only; the port has no such switch)."""
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa

    saved = da.ctx_attention, fa.flash_attention
    da.ctx_attention, fa.flash_attention = da._ctx_reference, fa.attention_reference
    try:
        yield
    finally:
        da.ctx_attention, fa.flash_attention = saved


def one_step(model, batch, index: int = 25):
    """Phase 3: one full-width CFG noise prediction at DDIM index `index`,
    from the same seeded noisy latents whatever the model's dtype."""
    from morphablediffusion_torch.ops import schedules

    m = model.cfg
    dev = model.device
    prep = model.prepare_inference(batch)
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((1, m.view_num, m.latent_size, m.latent_size, 4), generator=g, device=dev)
    sched = schedules.make_diffusion_schedule(device=dev)
    ts = schedules.make_ddim_timesteps(m.sample_steps, sched.num_timesteps)
    t = torch.full((1,), int(ts[index]), dtype=torch.int64, device=dev)
    eps = model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"], prep["v_embed"],
                                batch, m.cfg_scale)
    torch.cuda.synchronize()
    return eps


def profile_step(sampler, batch, index: int = 25, top: int = 15):
    """Phase 5: torch.profiler over one denoising step (predict_eps_cfg and
    ddim_step at DDIM index `index`), after a warm-up step. Prints the
    device's busy and idle share of the step and its kernel time by group
    and by name."""
    from torch.profiler import ProfilerActivity, profile

    from morphablediffusion_torch.ops import schedules

    model = sampler.model
    m, dev = model.cfg, model.device
    g = torch.Generator(dev).manual_seed(5)
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    x, noise = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    t = torch.full((1,), int(sampler.timesteps[index]), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        step = lambda: schedules.ddim_step(
            x, model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                     prep["v_embed"], batch, m.cfg_scale),
            index, sampler.ddim, noise)
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
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        raise AssertionError("torch.profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3

    def group(name: str) -> str:
        low = name.lower()
        if "depth_ctx_kernel" in name:
            return "K1 depth_attention_ctx"
        if "flash_fwd_kernel" in name:
            return "K2 flash_attention"
        if any(w in low for w in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
            return "convolution (cuDNN)"
        if any(w in low for w in ("gemm", "nvjet", "matmul", "cublas")):
            return "matmul (cuBLAS)"
        if "grid_sampler" in low:
            return "grid_sample"
        if "reduce" in low or "norm" in low:
            return "reductions and norms"
        return "elementwise and other"

    by_group, by_name = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us() / 1e3
        gname = group(e.name)
        by_group[gname] = by_group.get(gname, 0.0) + us
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
    # the profiler slows the host, not the device: idle share is taken
    # against the unprofiled step
    log(f"phase 5 one denoising step: {plain_wall * 1e3:.2f} ms unprofiled, "
        f"{wall * 1e3:.2f} ms profiled; device busy {busy:.2f} ms over a "
        f"{span:.2f} ms device span; idle share of the unprofiled step "
        f"{1 - busy / (plain_wall * 1e3):.3f}; {len(kern)} device activities")
    for gname, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.3f} ms {ms / busy:6.1%}  {gname}")
    for name, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms x{c:<4d} {name[:110]}")


def kernel_entry(name, source, replaces, rows, launches):
    """One kernel of the kernels line. ms, plain_ms, bound_ms and
    library_ms are per launch, averaged over the main path's launch mix
    (so launches * ms is the kernel's time per avatar)."""
    n = sum(r["per_step"] for r in rows)
    mean = lambda key: sum(r["per_step"] * r[key] for r in rows) / n
    flops, nbytes = mean("flops"), mean("bytes")
    lib = rows[0].get("library_ms")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": None if lib is None else mean("library_ms"),
        "shapes": [{k: r[k] for k in ("shape", "per_step", "ms", "plain_ms", "bound_ms",
                                      "rel_l2")} for r in rows],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.ops import _cuda
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.weights import seeded_params

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    kernels = (da.KERNEL, fa.KERNEL)
    _cuda.build(kernels)
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        log(f"  {k.name}: nvcc {k.build_seconds:.2f} s; {regs}")

    cfg = Config()
    k1_shapes, k2_shape = main_path_shapes(cfg)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    with torch.inference_mode():
        checked = check_kernels(k1_shapes, k2_shape, device)
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    # 3. one full-width step: bf16 with the kernels, bf16 with the plain
    # versions, and the fp32 model (same seeded weights, plain versions)
    t0 = time.perf_counter()
    model = serving_model(cfg, device, seed=0)
    batch = flagship_batch(cfg, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    model32 = seeded_params(MorphableDiffusion(cfg32.model, device=device), 0).eval()
    with torch.inference_mode():
        eps = one_step(model, batch)
        with plain_versions():
            eps_plain = one_step(model, batch)
            eps32 = one_step(model32, batch)
    del model32
    step_err = rel_l2(eps, eps_plain)
    err_k, err_p = rel_l2(eps, eps32), rel_l2(eps_plain, eps32)
    log(f"phase 3 one predict_eps_cfg step ({n_params / 1e6:.1f} M params): eps "
        f"{tuple(eps.shape)} rel_l2 kernels vs plain = {step_err:.3e}; vs the fp32 "
        f"model: kernels {err_k:.3e}, plain bf16 {err_p:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (not torch.isfinite(eps).all() or not step_err <= REL_L2_STEP
            or not err_k <= STEP_VS_FP32_RATIO * err_p):
        raise AssertionError(f"step: finite={bool(torch.isfinite(eps).all())} "
                             f"rel L2 {step_err:.3e} (bound {REL_L2_STEP}); vs fp32 "
                             f"{err_k:.3e} (bound {STEP_VS_FP32_RATIO} x {err_p:.3e})")
    del eps, eps_plain, eps32

    # 4. the full avatar
    sampler = SyncDDIMSampler(model, sample_steps=cfg.model.sample_steps)
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.perf_counter()
    sampler.sample(batch, cfg.model.cfg_scale, generator=gen)
    torch.cuda.synchronize()
    log(f"phase 4 warm-up avatar: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    images, latents = sampler.sample(batch, cfg.model.cfg_scale, generator=gen)
    ev1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    steps = cfg.model.sample_steps
    want = {"depth_attention_ctx": steps * sum(s["per_step"] for s in k1_shapes),
            "flash_attention": steps * k2_shape["per_step"]}
    log(f"phase 4 avatar: {ev0.elapsed_time(ev1) / 1e3:.3f} s (CUDA events), "
        f"{host_s:.3f} s host clock; peak allocated {peak / 2**30:.2f} GiB; "
        f"launches {launches} (expected {want})")
    m = cfg.model
    shape = (1, m.view_num, m.image_size, m.image_size, 3)
    finite = bool(torch.isfinite(images).all())
    spread = float(images.float().std())
    log(f"  images {tuple(images.shape)} finite={finite} std={spread:.4f} "
        f"mean={float(images.float().mean()):.4f}; latents {tuple(latents.shape)}")
    if tuple(images.shape) != shape or not finite or not spread > 0:
        raise AssertionError("the avatar's images are not finite, non-constant and "
                             f"of shape {shape}")
    if launches != want or want != {"depth_attention_ctx": 500, "flash_attention": 250}:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    # 5. where one denoising step's device time goes
    profile_step(sampler, batch)

    # 6. results
    entries = [
        kernel_entry("depth_attention_ctx", "morphablediffusion_torch/csrc/depth_attention_ctx.cu",
                     "morphablediffusion_tpu/ops/depth_attention.py:236",
                     checked["depth_attention_ctx"], launches["depth_attention_ctx"]),
        kernel_entry("flash_attention", "morphablediffusion_torch/csrc/flash_attention.cu",
                     "morphablediffusion_tpu/models/layers.py:277",
                     checked["flash_attention"], launches["flash_attention"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    for e in entries:
        if not all(math.isfinite(e[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing in {e}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
