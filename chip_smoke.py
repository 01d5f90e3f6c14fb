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
     serving path and the training path give it (K1 and K2 at both; K2's
     row logsumexp within 1e-4 of the plain one), in bf16, within relative
     L2 1e-2, and time the kernel, the plain version and, as the yardstick
     `library_ms` (the port never calls it), F.scaled_dot_product_attention
     for flash attention and depth attention, and its backward for the
     flash backward kernels (K2-dkv and K2-dq against the plain version's
     autograd gradients and against their own plain versions,
     `backward_dkv_reference` and `backward_dq_reference`). K1 logs the
     design that `ctx_design` picks at each shape (its G and grid) and, at
     the Hopper design's shapes, holds and times every other design the
     shape could take (the other G, the WMMA design); at the cluster
     design's (W=8, W=4) it logs the plan (cluster, rows a tile, grid, ring
     stages, shared memory, which must equal the kernel's, and the clusters
     the card holds at once) and holds and times the WMMA design beside it,
     and its ptxas resources are read in phase 1 (any spill fails). K1, K2, K2-dkv,
     K2-dq, K3, SDPA and its backward are also timed on the device alone
     (torch.profiler), and the registers, shared memory and spill bytes of
     K1's Hopper design, of the three K2 kernels and (in phase 1) of K3's
     and K4's every instantiation are read from their `-Xptxas -v` build
     log (any spill fails). K3 (at all four widths) and K4 log their plan
     (cluster size, tile or pack, grid, shared memory) and the clusters the
     card holds at once (cudaOccupancyMaxActiveClusters). K4 (GroupNorm)
     is held the same way at every GroupNorm call that the censuses of
     phases 3, 6, 7, 8, 9, 10, 11 and 13 find, after phase 13 (and at every shape no
     further from an fp64 GroupNorm than the plain version is, times 1 + a
     margin; K4 given eps x 10 must fail that gate at some shape of each
     dtype and layout), each call in the layout the model gives it (NCHW or
     channels-last, the census's),
     with its device time beside its yardstick's
     (F.group_norm and the activation, on the same map) at every shape and
     summed per avatar
     and per training step, the largest span, and at the widest spans the
     other shares a block could hold (`gn_alternatives`);
  3. one full-width `predict_eps_cfg` step with the kernels and with the
     plain versions, in bf16; print and bound the relative L2 between the
     two, and hold the kernels' step no further from the fp32 model (same
     seeded weights, plain versions) than 1.25 x the plain bf16 step; count
     the avatar's GroupNorm calls by shape (VAE encode, one step, decode);
  4. the full avatar: `Config()` defaults (16 views at 256^2, bf16, CFG 2.0,
     50 DDIM steps, coarse mesh voxels), seeded weights cast for serving; one
     warm-up run, then one timed run with every launch counter set to 0
     just before it: the depth-context kernel must launch 500 times (350
     in its Hopper design, W=32 and W=16; 150 in the cluster design, W=8
     and W=4; 0 in the WMMA one), the flash
     kernel 250 times and K4 once per GroupNorm (5 902)
     call of the census, the images must be finite and not constant, and
     the warm-up and the timed avatar (the same seed and noise) must be
     bitwise equal, latents and images (the serving path scatters its mesh
     voxels in order);
  5. profile one denoising step with torch.profiler
     (`morphablediffusion_torch/tools/profile_step.py`): the device's busy
     and idle share and its kernel time by group and by name; then the
     step's mesh-voxel scatter at its inputs, ordered against index_add_
     (device ms, and the ordered one bitwise equal in two calls);
  6. training: `Config()` defaults at full width and depth (remat on),
     seeded weights, a synthetic batch of 8 samples x 16 target views plus
     the input view. One loss and backward with the kernels and with the
     plain versions on the same draws (loss, global grad norm and named
     gradient leaves printed and bounded by twice the gap between two runs
     of the plain versions plus a floor); then 2 warm-up steps (the first
     counts the step's GroupNorm calls, remat's reruns included) and 5 timed
     `Trainer.train_step`s with every launch counter set to 0 just before
     them: ms per step (CUDA events), samples/s, peak memory, and launches
     per step of K1, K2, K2-dkv, K2-dq, K3 and K4, asserted; the loss finite
     and the parameters changed; then one profiled training step;
  7. the other configurations at full width, each with a step as in phase 3
     and a GroupNorm census: THuman (orthographic, coarse grid (80, 48, 80),
     10 496 vertices; also a warm-up and a timed avatar with launch counts),
     the fine mesh-voxel conditioner (grid (128, 144, 128) at 0.005 m; also
     a timed avatar) and `use_spatial_volume`;
  8. the generate_face CLI (`apps/generate_face.py`), as a user runs it
     (`main([...])`; where PIL or PyYAML is missing, through `run(...)` with
     `Config()` and a synthetic image, the files then held by the CPU tests
     only): (a) a flagship-width reference-named fp16 checkpoint of the fine
     model's seeded weights (`export_torch_checkpoint`), held back through
     the importer (every imported tensor the fp16-rounded seeded one, the
     others untouched); (b) the documented run on it (`demo/input.png`,
     `demo/mesh.obj`, `--no_mica_alignment --prepare_neus2_data`): the fine
     conditioner at grid (112, 120, 116), the import report (0 unused, 0
     unmatched, every tensor of the file filled), launches per avatar (K1
     350 + 150 + 0, K2 250, K4 this avatar's GroupNorm census), the strip,
     16 RGBA views and transform.json, finite non-constant views, and the
     CLI's seconds in parts; (c) `--ckpt random --w8a8` on the RGB photo
     `demo/real_input.png` (native matting) and the ASCII PLY
     `artifacts/real_photo/real_input_fitted_mesh.ply` (MICA alignment,
     coarse conditioner) with the same checks; (d) the int8 convs' device
     time in one profiled W8A8 step of `Config()`'s seeded weights (the
     bf16-vs-W8A8 drift is phase 13 (c)'s);
  9. training complete: (a) the port's synthetic FaceScape tool writes a
     tree of 5 subjects x 2 expressions x 16 views at 128^2; (b)
     `apps/train_vae.py` through `main([...])` at the CLI's defaults (ch 32,
     mult 1,2,2,4, one block, 128^2, batch 16) for 40 steps: ms/step, the
     loss finite and falling, K4 once per GroupNorm call of the step's census
     (one channel a group included) and no other kernel, the JAX meta keys,
     and decode(encode(x)) unchanged by the latent fold (fp32, relative L2
     1e-4) with z * 0.18215 about unit-variance; (c) `apps/train.py` through
     `main([...])` on a copy of `configs/synth_scratch.yaml` on that tree with
     `--vae_from` the file of (b), 4 steps and the validation avatar (10
     sampler steps, not the config's 50) at the last: launches per training step (K1 by design at W=8, K3 at W=16, 4
     and 2, K2 none: its L=256 takes SDPA) and of the avatar (K1 at W=8 and
     W=4, the latter in the WMMA design; K3 at W=16 and 2), K4 once per
     GroupNorm call, the first stage equal to the file's tensors, the contact
     sheet not constant; (d) full-width training under THuman, the fine
     conditioner and `use_spatial_volume` (batch 8, remat, seeded weights, a
     synthetic batch; under the fine conditioner one loss and backward with
     the kernels, the plain versions and the fp32 model, the kernels' loss,
     grad norm and named leaves (the xyzc net's too) no further from the
     fp32 model than 1.25x the plain versions' plus phase 6's floors: its
     plain versions are deterministic, so phase 6's plain-vs-plain gap is
     0 there): 1 warm-up
     and 3 timed `Trainer.train_step`s, ms/step, samples/s, peak memory,
     launches per step asserted, the loss finite and the parameters moved;
     (e) before (c), phase 2 at synth_scratch's new shapes (K1 at W=8 and 4,
     K3 at W=16, 4 and 2), and K4's check below takes the censuses of (b),
     (c) and (d);
  10. the eval harness (`apps/eval_*`, `train_keypoints`, `calibrate_reid`)
     through `main([...])` on the port's synthetic tree (2 subjects x 2
     expressions x 20 views at 256^2, landmarks painted): (a) the inputs: the
     tree, a reference-named fp16 checkpoint of `Config()`'s seeded weights,
     facescape.yaml pointed at the tree's meshes, seeded VGG16 / lpips-lin /
     IR-SE50 files in the published namings; (b) eval_select_views, phase 2
     at one sampler call's shapes (K1 at B=32, K2 at B=64), then
     eval_generate --mode nes --limit 2 at full width: 20 targets make 2
     view groups, so each sampler call runs at B=2, with launches a call (K1
     350 + 150 + 0, K2 250, K4 the call's GroupNorm census), its seconds
     (CUDA events) and peak memory, and strips finite, not constant, 20
     tiles each; (c) train_keypoints on the mesh labels, 256^2, batch 16,
     200 steps: the loss finite and falling, K4 14 launches a step and no
     other kernel; (d) eval_keypoints --backend native on the GT views and
     on the strips; (e) calibrate_reid --pairing same_view with the irse and
     the landmark embedders; (f) eval_2d with all five metrics at (e)'s
     EER threshold, each present, finite and in range, then on strips equal
     to the ground truth as eval_2d loads it (SSIM > 0.99, FID < 1e-3,
     LPIPS < 1e-6, Re-ID 1.0, PCK 1.0); (g) LPIPS, IR-SE50 and CLIP (relative
     L2 1e-4) and the landmark coordinates (0.05 px) on the card against
     the port's CPU run, TF32 off; (h) each stage's seconds; its GroupNorm
     censuses go to K4's check;
  11. FLAME fitting (`apps/fit_face.py`) through `main([...])` on the
     port's synthetic FLAME assets at FLAME2020's widths (5 023 vertices,
     9 976 faces, 100 + 50 codes, 51 + 79 x 17 landmarks): (a) the tool and
     `load_model` on the card; (b) two photos' ground truth from a seed, 68
     landmarks each at 512^2 with 0.5 px of noise, fit_face at 40 LM
     iterations a stage, then with --overlay: each LM stage timed with no
     host sync inside it (`set_sync_debug_mode`; the process's first stage
     may sync once as cuSOLVER and functorch initialize), the PLY 5 023 finite
     vertices, each photo's mean reprojection error <= 1 px; (c)
     --kpt_weights with phase 10 (c)'s net at 256^2 on two of phase 10's
     painted views: K4 once per GroupNorm call (14 a photo) and nothing
     else, its shapes added to K4's check, the detections on the card
     against the CPU (0.05 px with TF32 off, 1 px with cuDNN TF32 on); (d)
     (b)'s fit with --device cpu: the PLYs' vertices (relative L2 0.1),
     each photo's canonical parameters (0.7) and reprojection error (0.3
     px), two fp32 fits that stop apart (the CPU's own spread under 1e-3 px
     moves printed beside), and at the ground truth the residuals and
     Jacobian (1e-5) and one LM proposal through J (1e-3); (e) the C++ rasterizer against its numpy version at the mesh,
     512^2 (coverage but on triangle edges, depth 1e-5 relative), then
     --silhouette on photos painted with the ground truth's silhouette; (f)
     `render_depth_cv` and `calibrate_colors` on a 16-view 256^2 synthetic
     capture of the head; each part's seconds;
  12. more than one rank (`parallel/`), at full width: (a) K1 and K2 at the
     serving shapes of one of 2 and of 4 ranks (K1 at B=8 and 4: its design,
     cluster plan and the clusters the card holds; K2 at B=16 and 8), the
     training kernels at 4 samples a rank, and K4 at every shape of the
     ranks' GroupNorm censuses, each against its plain version at phase 2's
     gates; (b) two spawned ranks sharing the card under gloo: one CFG step
     against phase 3's (within 5e-2, no further from the fp32 model than
     1.25x the plain step), every rank's spatial volumes bitwise equal, a
     50-step avatar with the launches per rank (K1 350 + 150, K2 250, K4 the
     rank's census), its final latent against the one-process avatar's
     (relative L2 0.0505) and its images (37 dB), the collectives' host time
     a step (staged through the host under gloo: nothing of NCCL); then
     generate_face --view_parallel under torchrun on phase 8's documented
     inputs with seeded weights against the one-process strip (37 dB);
     (c) in the same ranks two Trainer steps at a global batch of 8: loss,
     grad norm and phase 6's ten leaves against the one-process step on the
     same draws at phase 6's gates (the loss and grad norm of step i within
     2x step i's run-to-run gap, the largest between one process's three
     runs of the two Trainer steps from the same start, one with the
     kernels and two with the plain versions, plus the floors), each rank's
     AdamW moments <= 0.51x one process's, its peak memory; then train.py under torchrun (2 steps of
     synth_scratch, rank 0 writes the checkpoint) resumed in one process;
     (d) a one-rank NCCL group: (b)'s step and (c)'s train step (the same
     gradients given to both optimizers) within 1e-6 of world 1; NCCL
     across two cards only where the machine has two ("nccl multi-card:
     not run (1 card)" otherwise);
  13. (run after phase 11, before K4's check) the JAX package's weight
     files and the repository's quality and sizing tools on the port
     (`morphablediffusion_torch/tools/`): (a) the shipped landmark net
     `artifacts/landmark_net_synth.msgpack` read without flax, the held-out
     tree of `artifacts/pck_heldout.json` regenerated from its recipe (40
     subjects x 2 expressions x 16 views at 128^2, subjects 038 - 040 held
     out; a process of its own started after phase 10, beside phase 11),
     eval_landmark_net on the card plain and shifted (K4 once per
     GroupNorm call, its 128^2 fp32 shapes added to K4's check), the plain
     PCK@0.2 and mean pixel error within 0.01 and 0.1 px of the artifact's;
     (b) eval_flame_fit, 1 trial at FLAME2020 widths at 0 and 0.5 px of
     noise; (c) make_flagship_ckpt (its fp32 file) and int8_trajectory on
     it at full width: a bf16 and a W8A8 avatar on the same noise draws
     (seed 7, 50 steps), the final latent's relative L2 and the final
     images' PSNR gated (<= 0.0505, >= 37 dB: twice the JAX study's
     error); (d) memory_report at batch 8 and 16 views; (e) eval_matting (6
     samples) and eval_anchors on phase 10's tree; (f) eval_synth_scratch.sh
     on phase 9's run (4 sampler steps; started with (a)'s tree, beside
     phase 11), eval_2d's metrics finite; each part's seconds;
  15. (run after phase 12, before 14's lines) the JAX package's Orbax run
     directories read without JAX (`utils/orbax_reader.py`): (a) the libzstd
     the reader loaded (its path and ZSTD_versionNumber; the only decoder);
     (b) `tools/make_orbax_run.py` writes `Config()`'s seeded fp32 model
     (seed 0, ~4.93 GiB) as a JAX params export: its size and write time;
     (c) generate_face through `main([...])` on phase 8's documented inputs
     with `--ckpt` that directory (16 views, 256^2, 50 steps, CFG 2.0, bf16,
     B=1): the read time and GiB/s, the avatar's time, the launches (K1 350
     + 150 + 0, K2 250, K4 5 902), and the views and strip bitwise equal to
     `--ckpt random`'s (the same seeded weights in-process, the same seed);
     (d) the committed JAX-written fixture
     (`morphablediffusion_torch/tools/fixtures/`, tests/tiny.py's config at
     UNet width 64 so that every GroupNorm group holds two channels): its
     params export and TrainState read on the card, every leaf's sha256 the
     committed one; (e) `train --resume`'s restore of that TrainState into
     the port's Trainer (that config, accumulation 2), the next
     micro-step (an AdamW step on the resumed moments) in bf16 with the
     kernels, twice with the plain versions, and in fp32, each from the same
     state: the plain versions being deterministic there, the kernels'
     loss, grad norm and parameter update no further from the fp32 step than
     1.25x the plain bf16 step's distance plus phase 6's floors (phase 9
     (d)'s form of phase 6's gate); (f) at full width: a Trainer of
     configs/facescape.yaml at accumulation 2 takes 3 micro-steps (an AdamW
     step, then half an accumulation), `make_orbax_run.export_train_state`
     writes its state as the JAX train CLI's `last/3` (its size, write time
     and GiB/s), and the train CLI (`main([... "--resume"])`) on that run
     directory and a small synthetic tree reads it (the read's seconds,
     GiB/s and the host RSS above its start, gated below half the state's
     bytes), holds the state it restored bitwise equal to the writer's, takes
     micro-step 3 with the kernels (K3, K4 and K2's backward launched) and
     writes its own checkpoint;
  14. print the kernels line, the card line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Fp32 references on the card run with TF32 off: both
`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
are set to False at start (the serving path itself runs in bf16).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from morphablediffusion_torch.tools.common import card_line, flagship_batch  # noqa: E402
from morphablediffusion_torch.tools.profile_step import (  # noqa: E402
    device_events, profile_report, profile_step)

# Published dense peaks of one H100 SXM (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
REL_L2_KERNEL = 1e-2  # bf16 kernel vs its plain bf16 version
# K4's relative L2 to GroupNorm computed in fp64 may exceed the plain
# version's by the factor 1 + K4_MARGIN[dtype] + K4_FLIPS / outputs at any
# census shape. In bf16 that distance is the output's rounding (~1.7e-3) and
# grows with the square of the fp32 arithmetic's error; an output near a
# rounding midpoint that rounds the other way moves it by up to ~2e-3 /
# outputs, and the second term allows ten such at any shape (the smallest
# has 64 outputs). K4 against the plain version counts those flips alone:
# one of a value near 2 among 32 768 outputs is 1.1e-4
K4_MARGIN = {torch.bfloat16: 1e-7, torch.float32: 0.1}
K4_FLIPS = 0.02
L2_BYTES = 50e6  # the H100's L2: a call that moves less stays in it while timed
GN_LAYOUTS = {0: "NCHW", 1: "NHWC"}  # K4's layouts (ops/group_norm.py NCHW, NHWC)
REL_L2_STEP = 5e-2  # one whole bf16 CFG step, kernels vs plain versions
TRAIN_BATCH = 8  # samples per training step, one noisy target view each
TRAIN_STEPS = 5  # timed training steps, after 2 warm-up steps
# one bf16 training loss and backward, kernels vs plain versions: the loss,
# the global grad norm (relative) and each named gradient leaf (relative
# L2). Each may differ by NOISE_FACTOR x the gap between two runs of the
# plain versions (cuDNN's and grid_sample's backward are not deterministic;
# on the frustum net's first conv that gap alone measured 6.5e-2) plus its
# floor. Measured kernels vs plain on an H100: loss 6e-6 to 6e-5, grad norm
# 1e-4 to 5e-4 (plain vs plain up to 1.1e-4 and 7.8e-4).
REL_TRAIN_LOSS = 2e-4
REL_TRAIN_GRAD = 1e-3
REL_TRAIN_LEAF = 2e-2
NOISE_FACTOR = 2.0
# the kernels' bf16 step may sit at most this much further from the fp32
# model than the plain versions' bf16 step does (both measured ~2.2e-2)
STEP_VS_FP32_RATIO = 1.25
# phase 8: the generate_face CLI's documented inputs, the fine grid that
# demo/mesh.obj crops to at 0.005 m, the other inputs, and (phase 13 (c)) the W8A8 drift
# gate: twice the JAX study's error (artifacts/int8_trajectory.json: final
# latent relative L2 0.02525, final-image PSNR 43.03 dB), its weights not
# being these
ROOT = Path(__file__).resolve().parent
CLI_INPUT, CLI_MESH = str(ROOT / "demo/input.png"), str(ROOT / "demo/mesh.obj")
CLI_FINE_GRID = (112, 120, 116)
CLI_PHOTO = str(ROOT / "demo/real_input.png")
CLI_PLY = str(ROOT / "artifacts/real_photo/real_input_fitted_mesh.ply")
CLI_CONFIG = str(ROOT / "configs/facescape.yaml")
W8A8_SEED, W8A8_STEPS = 7, 50
W8A8_MAX_REL_L2, W8A8_MIN_PSNR = 0.0505, 37.0


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


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


def serving_model(cfg, device, seed: int = 0, cast: bool = True):
    """The model of `cfg` with seeded weights, cast for serving unless
    cast=False (fp32 weights)."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.weights import cast_for_serving, seeded_params

    model = seeded_params(MorphableDiffusion(cfg.model, device=device), seed)
    return (cast_for_serving(model) if cast else model).eval()


def depth_blocks(cfg, B: int, train: bool):
    """The UNet's DepthTransformers of `cfg` by frustum width, narrowest
    first: the width W, depth D, context and inner channels Cc and Ci, the
    blocks per UNet call (per_step) and whether they take the fused chain
    (K1) or the unfused one (K3) by `unet.fused_ok`; B samples a call."""
    from morphablediffusion_torch.models.unet import MIDDLE_COND_CTX, OUT_COND_CTX, fused_ok

    m = cfg.model
    ctx_index = [MIDDLE_COND_CTX, *OUT_COND_CTX.values()]  # width latent >> index
    blocks = []
    for i in sorted(set(ctx_index), reverse=True):
        W, Cc = m.latent_size >> i, m.unet.volume_dims[i]
        blocks.append(dict(B=B, W=W, D=m.frustum_volume_depth >> i, Cc=Cc, Ci=2 * Cc,
                           heads=4, per_step=ctx_index.count(i),
                           fused=fused_ok(4, Cc // 2, W, W, train)))
    return blocks


def main_path_shapes(cfg):
    """The shapes the main path gives each kernel, with launches per step.

    K1: every DepthTransformer of the UNet at serving that takes the fused
    chain (under `Config()` all of them); the frustum net halves depth with
    width. K2: the self-attention of the SpatialTransformers at ds=1 (L =
    latent^2 tokens), on the CFG-doubled batch, where `flash_ok` takes it
    (else per_step 0)."""
    from morphablediffusion_torch.models.layers import flash_ok

    m, u = cfg.model, cfg.model.unet
    k1 = [{k: v for k, v in s.items() if k != "fused"}
          for s in depth_blocks(cfg, m.view_num, train=False) if s["fused"]]
    L = m.latent_size ** 2
    ds1_transformers = (2 * u.num_res_blocks + 1) if 1 in u.attention_ds else 0
    k2 = dict(B=2 * m.view_num, L=L, heads=u.num_heads, hd=u.model_channels // u.num_heads,
              per_step=ds1_transformers if flash_ok(L, L) else 0)
    return k1, k2


def serving_k3_shapes(cfg, B: int):
    """K3's shapes at serving (the conditional half of B samples a UNet
    call): the DepthTransformers that take the unfused chain (none under
    `Config()`)."""
    return [dict(B=B, W=s["W"], D=s["D"], C=s["Ci"], heads=s["heads"], per_step=s["per_step"])
            for s in depth_blocks(cfg, B, train=False) if not s["fused"]]


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


def ptxas_resources(kernel, symbol: str):
    """Registers, static shared memory and spill bytes of the entry function
    whose mangled name contains `symbol`, from the kernel's `-Xptxas -v`
    build log; None if this process did not build it."""
    lines = kernel.build_log.splitlines()
    start = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln and symbol in ln]
    if not start:
        return None
    res = {}
    for ln in lines[start[0] + 1:]:
        if "Compiling entry function" in ln:
            break
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            res["spill_stores"], res["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            res["registers"] = int(m[1])
            smem = re.search(r"(\d+) bytes smem", ln)
            res["static_smem"] = int(smem[1]) if smem else 0
    return res


# K2's three kernels at head_dim 40: device symbol (mangled) by name
K2_SYMBOLS = {"forward": "md_flash_fwd_kernelILi40E", "dkv": "md_flash_bwd_dkv_kernelILi40E",
              "dq": "md_flash_bwd_dq_kernelILi40E"}


def k2_resources(which: str = "forward"):
    """K2's forward, K2-dkv or K2-dq at head_dim 40: the ptxas resources,
    and the dynamic shared memory of a block and the blocks per SM as the
    library reports them. Raises if ptxas reports spills."""
    from morphablediffusion_torch.ops import flash_attention as fa

    kernel = fa.KERNEL if which == "forward" else fa.BWD_DKV_KERNEL  # dkv and dq: one library
    res = ptxas_resources(kernel, K2_SYMBOLS[which])
    lib = ctypes.CDLL(str(kernel.lib_path()))
    if which == "forward":
        smem, blocks = lib.md_flash_attention_fwd_smem_bytes(), lib.md_flash_attention_fwd_blocks_per_sm()
    else:
        dkv = int(which == "dkv")
        smem = lib.md_flash_attention_bwd_smem_bytes(dkv)
        blocks = lib.md_flash_attention_bwd_blocks_per_sm(dkv)
    if res is None:
        return (f"dynamic smem {smem} B, {blocks} blocks per SM; ptxas resources not in this "
                "process's build log")
    if res["spill_stores"] or res["spill_loads"]:
        raise AssertionError(f"K2 {which} spills: {res}")
    return (f"{res['registers']} registers, dynamic smem {smem} B (static {res['static_smem']} B), "
            f"{blocks} blocks per SM, spill stores {res['spill_stores']} B, spill loads "
            f"{res['spill_loads']} B")


def entry_resources(kernel, stem: str):
    """The ptxas resources of every entry function of `kernel`'s library
    whose mangled name contains `stem`, one line each; None if this process
    did not build it. Raises if ptxas reports spills for any of them."""
    names = sorted({m[1] for m in re.finditer(r"Compiling entry function '(\w+)'",
                                               kernel.build_log) if stem in m[1]})
    if not names:
        return None
    lines = []
    for name in names:
        res = ptxas_resources(kernel, name)
        if res["spill_stores"] or res["spill_loads"]:
            raise AssertionError(f"{name} spills: {res}")
        lines.append(f"{name[name.index(stem):][:60]}: {res['registers']} registers, static "
                     f"smem {res['static_smem']} B, spill stores {res['spill_stores']} B, "
                     f"spill loads {res['spill_loads']} B")
    return "; ".join(lines)


def k3_plan_line(s, lib):
    """K3's plan at shape s (depth_plan) with the clusters the card holds at
    once (cudaOccupancyMaxActiveClusters); the kernel's shared-memory layout
    must agree with the plan's."""
    from morphablediffusion_torch.ops import depth_attention as da

    B, W, D, C, heads = s["B"], s["W"], s["D"], s["C"], s["heads"]
    plan = da.depth_plan(B, C, D, W * W, heads)
    smem = lib.md_depth_attention_smem_bytes(C, D, heads, plan.tile, plan.cluster)
    if smem != plan.smem:
        raise AssertionError(f"K3 at W={W}: the kernel's layout takes {smem} B, the plan "
                             f"{plan.smem} B")
    active = lib.md_depth_attention_max_clusters(C, D, W * W, heads, plan.tile, plan.cluster,
                                                 plan.vec)
    return (f"plan cluster={plan.cluster} tile={plan.tile} vec={plan.vec} grid={plan.blocks} "
            f"blocks smem={plan.smem} B, max active clusters {active}")


def queued_ms(fn, iters: int = 10) -> float:
    """Device time per call of fn by CUDA events, with the host's launch
    path hidden: the calls are queued behind a ~10 ms sleep kernel, so the
    device runs them back to back (the small gap between two launches
    included). After a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


UNTRACED = []  # device_ms calls whose kernels torch.profiler did not record


def device_ms(fn, iters: int = 10, attempts: int = 2):
    """Device time per call of fn, summed over every kernel it launches,
    over `iters` calls under torch.profiler after a warm-up call: the
    kernels' own time, without the host's launch path. Returns (ms, the
    kernels' names).

    torch.profiler on the H100 can lose the records of launches made with
    cudaLaunchKernelEx (the cluster kernels K3 and K4): seen, the first of
    ten, and at times all of them. So each kernel's time is its mean over
    the records kept, times the launches per call that its count gives (at
    least 1); a run that recorded nothing is repeated, and if `attempts`
    runs record nothing the time is `queued_ms`'s (counted in UNTRACED)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = device_events(prof)
        if kern:
            break
    else:
        UNTRACED.append(fn)
        return queued_ms(fn, iters), ["(not traced: CUDA events behind a sleep)"]
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    us = sum(sum(t) / len(t) * max(1, round(len(t) / iters)) for t in by_name.values())
    return us / 1e3, sorted({n[:90] for n in by_name})


def k1_kernel(s):
    """The CudaKernel of the K1 design that `ctx_design` picks for shape s."""
    from morphablediffusion_torch.ops import depth_attention as da

    return da.CTX_KERNELS[da.ctx_design(s["B"], s["W"] ** 2, s["Cc"], s["Ci"], s["heads"]).kernel]


def k1_launches(shapes):
    """K1's launches per step by design (its kernels' names; their sum is
    K1's launches)."""
    from morphablediffusion_torch.ops import depth_attention as da

    n = {k.name: 0 for k in da.CTX_KERNELS.values()}
    for s in shapes:
        n[k1_kernel(s).name] += s["per_step"]
    return n


def k1_alternatives(s):
    """The designs shape s could also run, besides `ctx_design`'s: every
    other G of the Hopper design and the WMMA design (timed beside it in
    the same call, never launched by the port)."""
    from morphablediffusion_torch.ops import depth_attention as da

    B, S, Cc, Ci, heads = s["B"], s["W"] ** 2, s["Cc"], s["Ci"], s["heads"]
    chosen = da.ctx_design(B, S, Cc, Ci, heads)
    if chosen.kernel == "wmma":
        return []
    alts = [da.CtxDesign("wgmma", g, da.WGMMA_TILE)
            for g, _ in da.WGMMA_GROUPS.get((Cc, Ci // heads), ())
            if g != chosen.group and heads % g == 0]
    if chosen.kernel == "cluster":  # the other number of tiles a cluster, where built
        alts += [da.CtxDesign("cluster", chosen.group, da.CLUSTER_ROWS * t)
                 for t in da.CLUSTER_TPC[Cc] if da.CLUSTER_ROWS * t != chosen.tile]
    return alts + [da.CtxDesign("wmma", 1, da._tile(B, S, heads))]


def k1_plan_line(s, lib):
    """K1's cluster-design plan at shape s (ctx_cluster_plan) with the
    clusters the card holds at once (cudaOccupancyMaxActiveClusters); the
    kernel's shared-memory layout (ring stages included) must agree with the
    plan's."""
    from morphablediffusion_torch.ops import depth_attention as da

    B, W, D, Cc = s["B"], s["W"], s["D"], s["Cc"]
    plan = da.ctx_cluster_plan(B, W * W, D, Cc, s["Ci"], s["heads"])
    smem = lib.md_depth_attention_ctx_cluster_smem_bytes(Cc, plan.tpc)
    if smem != plan.smem:
        raise AssertionError(f"K1 cluster design at W={W}: the kernel's layout takes {smem} B, "
                             f"the plan {plan.smem} B")
    return (f"plan cluster={plan.cluster} tiles/cluster={plan.tpc} samples/tile={plan.samples} "
            f"tiles={plan.tiles} grid={plan.blocks} blocks stages={plan.stages} smem="
            f"{plan.smem} B (held: {plan.held}; streamed: {plan.streamed}), max active "
            f"clusters {lib.md_depth_attention_ctx_cluster_max_clusters(Cc, plan.tpc)}")


def check_k1(shapes, device, rn, iters: int, path: str):
    """K1 against `_ctx_reference` at each of `shapes` (one row each, tagged
    with the path, serving or training, whose launches per_step counts),
    timed by CUDA events and on the device alone; at the Hopper design's
    shapes also every alternative design, held to the same bar. Returns
    {kernel name: rows} by the design that `ctx_design` picks."""
    from morphablediffusion_torch.ops import depth_attention as da

    rows = {k.name: [] for k in da.CTX_KERNELS.values()}
    lib = ctypes.CDLL(str(da.CLUSTER_KERNEL.lib_path()))
    for s in shapes:
        B, W, D, Cc, Ci, heads = s["B"], s["W"], s["D"], s["Cc"], s["Ci"], s["heads"]
        q, ctx = rn(B, Ci, W, W), rn(B, Cc, D, W, W)
        Wp, Wk, Wv = (rn(Cc, Cc, std=Cc ** -0.5), rn(Ci, Cc, std=Cc ** -0.5),
                      rn(Ci, Cc, std=Cc ** -0.5))
        mean_x, m2 = da.ctx_moments(ctx)
        A, B2 = da._ctx_affine(mean_x, m2, Wp, torch.ones(Cc, device=device),
                               torch.zeros(Cc, device=device), 8, 1e-5)
        args = (q, ctx, Wp, A, B2, Wk, Wv, heads)
        design, kernel = da.ctx_design(B, W * W, Cc, Ci, heads), k1_kernel(s)
        before = kernel.launches
        out = da.ctx_attention(*args)
        plain = da._ctx_reference(*args)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"K1 at W={W} B={B}: {kernel.name} did not launch once")
        err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
        ms = cuda_ms(lambda: da.ctx_attention(*args), iters)
        dev_ms, _ = device_ms(lambda: da.ctx_attention(*args))
        plain_ms = cuda_ms(lambda: da._ctx_reference(*args), max(2, iters // 4))
        flops, nbytes = k1_cost(s)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"K1 depth_attention_ctx ({path}) W={W} D={D} Cc={Cc} Ci={Ci} B={B}: design "
            f"{design.kernel} G={design.group} tile={design.tile} grid="
            f"{design.blocks(B, W * W, heads)} blocks: rel_l2={err:.3e} max_abs={mae:.3e} "
            f"ms={ms:.4f} (device {dev_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), {b_ms / dev_ms:.1%} of "
            f"the bound on the device, x{s['per_step']}/step")
        if design.kernel == "cluster":
            log(f"  {k1_plan_line(s, lib)}")
        alt_errs = []
        for alt in k1_alternatives(s):
            launch = lambda: da._launch_ctx(*args, alt)
            alt_err = rel_l2(launch(), plain)
            alt_errs.append(alt_err)
            alt_ms = cuda_ms(launch, iters)
            alt_dev, _ = device_ms(launch)
            log(f"  alternative {alt.kernel} G={alt.group} tile={alt.tile} grid="
                f"{alt.blocks(B, W * W, heads)} blocks: rel_l2={alt_err:.3e} ms={alt_ms:.4f} "
                f"(device {alt_dev:.4f})")
        if not max([err, *alt_errs]) <= REL_L2_KERNEL:
            raise AssertionError(f"K1 ({path}) at W={W} B={B}: rel L2 {err:.3e} (alternative "
                                 f"designs {alt_errs}) > {REL_L2_KERNEL}")
        rows[kernel.name].append(dict(
            shape=f"B={B},W={W},D={D},Cc={Cc}", path=path, per_step=s["per_step"], ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, flops=flops, bytes=nbytes,
            rel_l2=err, max_abs_err=mae, design=f"{design.kernel} G={design.group}"))
    return rows


def k1_resources():
    """The Hopper design of K1 in each configuration it is built for: the
    ptxas resources, the dynamic shared memory of a block and the blocks per
    SM as the library reports them. Raises if ptxas reports spills."""
    from morphablediffusion_torch.ops import depth_attention as da

    kernel = da.WGMMA_KERNEL
    lib = ctypes.CDLL(str(kernel.lib_path()))
    lines = []
    for (Cc, hd), groups in da.WGMMA_GROUPS.items():
        for g, _ in groups:
            res = ptxas_resources(kernel, f"md_ctx_wgmma_kernelILi{Cc}ELi{hd}ELi{g}E")
            smem = lib.md_depth_attention_ctx_wgmma_smem_bytes(Cc, hd, g)
            blocks = lib.md_depth_attention_ctx_wgmma_blocks_per_sm(Cc, hd, g)
            if res is None:
                lines.append(f"Cc={Cc} hd={hd} G={g}: dynamic smem {smem} B, {blocks} blocks "
                             "per SM; ptxas resources not in this process's build log")
                continue
            if res["spill_stores"] or res["spill_loads"]:
                raise AssertionError(f"K1 wgmma Cc={Cc} hd={hd} G={g} spills: {res}")
            lines.append(f"Cc={Cc} hd={hd} G={g}: {res['registers']} registers, dynamic smem "
                         f"{smem} B, {blocks} blocks per SM, spill stores {res['spill_stores']} "
                         f"B, spill loads {res['spill_loads']} B")
    return "; ".join(lines)


def check_kernels(k1_shapes, k2_shape, device, iters: int = 10):
    """Phase 2: every kernel against its plain version at the main path's
    shapes, bf16. Returns {name: result} for the kernels line."""
    g = torch.Generator(device).manual_seed(0)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    results = {}

    results.update(check_k1(k1_shapes, device, rn, iters, "serving"))
    log(f"  K1 Hopper design resources: {k1_resources()}")
    results["flash_attention"] = [check_k2(k2_shape, device, rn, iters, "serving")]
    log(f"  K2 forward resources: {k2_resources()}")
    return results


def check_k2(s, device, rn, iters: int, path: str):
    """K2 against `attention_reference` (and its row logsumexp) at shape s,
    timed with SDPA beside it; returns the row, tagged with the path whose
    launches per_step counts."""
    from morphablediffusion_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    B, L, heads, hd = s["B"], s["L"], s["heads"], s["hd"]
    q, k, v = (rn(B, L, heads * hd) for _ in range(3))
    out = fa.flash_attention(q, k, v, heads)
    plain = fa.attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
    lse_err = rel_l2(fa._forward(q, k, v, heads)[1], fa.logsumexp_reference(q, k, heads))
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, heads), iters)
    plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v, heads), max(2, iters // 4))
    qh, kh, vh = (t.reshape(B, L, heads, hd).transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
    dev_ms, _ = device_ms(lambda: fa.flash_attention(q, k, v, heads))
    lib_dev_ms, lib_names = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops, nbytes = k2_cost(s)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"K2 flash_attention ({path}) B={B} L={L} heads={heads} hd={hd}: rel_l2={err:.3e} "
        f"max_abs={mae:.3e} lse rel_l2={lse_err:.2e} ms={ms:.4f} (device {dev_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} (device {lib_dev_ms:.4f}) "
        f"bound_ms={b_ms:.5f} ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
        f"{b_ms / ms:.1%} of the bound (device {b_ms / dev_ms:.1%}) x{s['per_step']}/step; "
        f"SDPA ran {lib_names}")
    if not (err <= REL_L2_KERNEL and lse_err <= 1e-4):
        raise AssertionError(f"K2 ({path}) at B={B}: rel L2 {err:.3e} > {REL_L2_KERNEL} or lse "
                             f"{lse_err:.2e} > 1e-4")
    return dict(shape=f"B={B},L={L},heads={heads},hd={hd}", path=path, per_step=s["per_step"],
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, flops=flops,
                bytes=nbytes, rel_l2=err, max_abs_err=mae, library_ms=lib_ms)


def train_shapes(cfg, B: int):
    """The shapes the training path gives each kernel, with per_step its
    launches per training step: every forward twice under remat (the
    forward and its recompute in the backward pass). The DepthTransformers
    that `unet.fused_ok` fuses in training take K1, the others K3; K3's
    other widths are checked too but do not run in training (per_step 0).
    K2 and its backward kernels (bwd_per_step, once per ds=1 self-attention)
    see one target view per sample."""
    fwd = 2 if cfg.model.unet.use_checkpoint else 1
    blocks = depth_blocks(cfg, B, train=True)
    k1 = [dict({k: v for k, v in s.items() if k != "fused"}, per_step=fwd * s["per_step"])
          for s in blocks if s["fused"]]
    k3 = [dict(B=B, W=s["W"], D=s["D"], C=s["Ci"], heads=s["heads"],
               per_step=0 if s["fused"] else fwd * s["per_step"]) for s in blocks]
    serving_k2 = main_path_shapes(cfg)[1]
    k2 = dict(serving_k2, B=B, per_step=fwd * serving_k2["per_step"],
              bwd_per_step=serving_k2["per_step"])
    return dict(k1=k1, k3=k3, k2=k2)


def k3_cost(s):
    """Depth attention on projected q, k, v: q.k and attn.v over D depths,
    q, k, v read once and out written once (bf16)."""
    B, C, D, S = s["B"], s["C"], s["D"], s["W"] ** 2
    return 4 * B * C * D * S, 2 * (2 * B * C * S + 2 * B * C * D * S)


def k2_bwd_cost(s, which: str):
    """dkv: S^T, dV, dP^T, dK (4 products); dq: S, dP, dQ (3 products), each
    2*L^2*hd per (sample, head). Bytes: q, k, v, dO read and the gradients
    written once in bf16, lse and di read once in fp32."""
    B, L, H, hd = s["B"], s["L"], s["heads"], s["hd"]
    n, stats = B * L * H * hd, 2 * 4 * B * H * L
    if which == "dkv":
        return 8 * B * H * L * L * hd, 2 * (4 * n + 2 * n) + stats
    return 6 * B * H * L * L * hd, 2 * (4 * n + n) + stats


def check_k3(shapes, device, rn, iters: int, path: str):
    """K3 against `_reference` at each of `shapes` (one row each, tagged with
    `path`), timed by CUDA events and on the device alone, with its plan and
    the yardstick F.scaled_dot_product_attention over each pixel's D depths
    (on tensors permuted beforehand). Returns the rows."""
    from morphablediffusion_torch.ops import depth_attention as da
    import torch.nn.functional as F

    rows = []
    k3_lib = ctypes.CDLL(str(da.DEPTH_KERNEL.lib_path()))
    for s in shapes:
        B, W, D, C, heads = s["B"], s["W"], s["D"], s["C"], s["heads"]
        S, hd = W * W, C // heads
        q, k, v = rn(B, C, W, W), rn(B, C, D, W, W), rn(B, C, D, W, W)
        out, plain = da.attention_kernel(q, k, v, heads), da._reference(q, k, v, heads)
        torch.cuda.synchronize()
        err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
        ms = cuda_ms(lambda: da.attention_kernel(q, k, v, heads), iters)
        plain_ms = cuda_ms(lambda: da._reference(q, k, v, heads), max(2, iters // 4))
        qs = q.reshape(B, heads, hd, S).permute(0, 3, 1, 2).reshape(B * S, heads, 1, hd)
        kv = [t.reshape(B, heads, hd, D, S).permute(0, 4, 1, 3, 2).reshape(
            B * S, heads, D, hd).contiguous() for t in (k, v)]
        qs = qs.contiguous()
        lib = F.scaled_dot_product_attention(qs, *kv).reshape(B, S, C).transpose(1, 2)
        lib_err = rel_l2(lib.reshape(q.shape), plain)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, *kv), iters)
        # the device's own time, the permutes above not counted
        dev_ms, _ = device_ms(lambda: da.attention_kernel(q, k, v, heads))
        lib_dev_ms, lib_names = device_ms(lambda: F.scaled_dot_product_attention(qs, *kv))
        flops, nbytes = k3_cost(s)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"K3 depth_attention ({path}) W={W} D={D} C={C} B={B}: rel_l2={err:.3e} "
            f"max_abs={mae:.3e} ms={ms:.4f} (device {dev_ms:.4f}) plain_ms={plain_ms:.4f} "
            f"sdpa_ms={lib_ms:.4f} (device {lib_dev_ms:.4f}; {lib_names}) (sdpa rel_l2 "
            f"{lib_err:.2e}) bound_ms={b_ms:.5f} ({b_by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {b_ms / dev_ms:.1%} of the bound on the device, "
            f"device K3/SDPA {dev_ms / lib_dev_ms:.2f}, x{s['per_step']}/step; "
            f"{k3_plan_line(s, k3_lib)}")
        if not (err <= REL_L2_KERNEL and lib_err <= REL_L2_KERNEL):
            raise AssertionError(f"K3 at W={W}: rel L2 {err:.3e} (sdpa {lib_err:.3e}) "
                                 f"> {REL_L2_KERNEL}")
        rows.append(dict(
            shape=f"B={B},W={W},D={D},C={C}", path=path, per_step=s["per_step"],
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, flops=flops,
            bytes=nbytes, rel_l2=err, max_abs_err=mae, library_ms=lib_ms,
            library_device_ms=lib_dev_ms))
    return rows


def check_train_kernels(shapes, device, iters: int = 10):
    """Phase 2 at the training path's shapes (`train_shapes`): K1's and K2's
    forward against their plain versions; K3 against `_reference` at every
    plain-path shape; K2-dkv and K2-dq against the gradients of the plain
    version by autograd; bf16, relative L2 1e-2. The yardsticks:
    F.scaled_dot_product_attention (K2's forward), the same over each
    pixel's D depths (K3, on tensors permuted beforehand) and its backward
    (K2-dkv and K2-dq: the one call computes dq, dk and dv)."""
    from morphablediffusion_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device).manual_seed(1)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    results = {}
    with torch.no_grad():
        results.update(check_k1(shapes["k1"], device, rn, iters, "training"))
        results["depth_attention"] = check_k3(shapes["k3"], device, rn, iters, "training")

    s = shapes["k2"]
    B, L, heads, hd = s["B"], s["L"], s["heads"], s["hd"]
    q, k, v, dout = (rn(B, L, heads * hd) for _ in range(4))
    with torch.no_grad():
        out, lse = fa._forward(q, k, v, heads)
        di = fa.row_dot(out, dout, heads)
        dk, dv = fa.backward_dkv(q, k, v, dout, lse, di, heads)
        dq = fa.backward_dq(q, k, v, dout, lse, di, heads)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref_out = fa.attention_reference(*leaves, heads)
    ref = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err = rel_l2(out, ref_out)
    fwd_mae = float((out.float() - ref_out.detach().float()).abs().max())
    errs = {"dq": rel_l2(dq, ref[0]), "dk": rel_l2(dk, ref[1]), "dv": rel_l2(dv, ref[2])}
    maes = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
    lse_err = rel_l2(lse, fa.logsumexp_reference(q, k, heads))
    with torch.no_grad():
        own = (fa.backward_dq_reference(q, k, v, dout, lse, di, heads),
               *fa.backward_dkv_reference(q, k, v, dout, lse, di, heads))
    own_errs = {n: rel_l2(a, b) for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), own)}
    del own
    with torch.no_grad():
        dkv_ms = cuda_ms(lambda: fa.backward_dkv(q, k, v, dout, lse, di, heads), iters)
        dq_ms = cuda_ms(lambda: fa.backward_dq(q, k, v, dout, lse, di, heads), iters)
        dkv_dev_ms, _ = device_ms(lambda: fa.backward_dkv(q, k, v, dout, lse, di, heads))
        dq_dev_ms, _ = device_ms(lambda: fa.backward_dq(q, k, v, dout, lse, di, heads))
        fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, heads), iters)
        fwd_dev_ms, _ = device_ms(lambda: fa.flash_attention(q, k, v, heads))
        plain_fwd_ms = cuda_ms(lambda: fa.attention_reference(q, k, v, heads), max(2, iters // 4))
    plain_iters = max(2, iters // 4)
    plain_dkv_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves[1:], dout,
                                                       retain_graph=True), plain_iters)
    plain_dq_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves[:1], dout,
                                                      retain_graph=True), plain_iters)
    qh, kh, vh = (t.detach().reshape(B, L, heads, hd).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
        lib_fwd_dev_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh)
    douth = dout.reshape(B, L, heads, hd).transpose(1, 2).contiguous()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), douth, retain_graph=True)
    lib_ms = cuda_ms(lib_bwd, iters)
    lib_dev_ms, lib_names = device_ms(lib_bwd)
    flops, nbytes = k2_cost(s)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"K2 flash_attention (training) B={B} L={L} heads={heads} hd={hd}: rel_l2="
        f"{fwd_err:.3e} max_abs={fwd_mae:.3e} ms={fwd_ms:.4f} (device {fwd_dev_ms:.4f}) "
        f"plain_ms={plain_fwd_ms:.4f} sdpa_ms={lib_fwd_ms:.4f} (device {lib_fwd_dev_ms:.4f}) "
        f"bound_ms={b_ms:.5f} ({b_by}), {b_ms / fwd_ms:.1%} of the bound (device "
        f"{b_ms / fwd_dev_ms:.1%}) x{s['per_step']}/step")
    log(f"  K2 forward resources: {k2_resources()}")
    log(f"K2 backward B={B} L={L} heads={heads} hd={hd}: rel_l2 vs autograd of the plain "
        f"version dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e}, vs the "
        f"kernels' plain versions dq={own_errs['dq']:.3e} dk={own_errs['dk']:.3e} "
        f"dv={own_errs['dv']:.3e}; lse rel_l2={lse_err:.2e}; dkv_ms={dkv_ms:.4f} (device "
        f"{dkv_dev_ms:.4f}) dq_ms={dq_ms:.4f} (device {dq_dev_ms:.4f}) plain "
        f"dkv_ms={plain_dkv_ms:.4f} plain dq_ms={plain_dq_ms:.4f} "
        f"sdpa_backward_ms={lib_ms:.4f} (device {lib_dev_ms:.4f}, its kernels {lib_names}) "
        f"x{s['bwd_per_step']}/step")
    for which in ("dkv", "dq"):
        log(f"  K2-{which} resources: {k2_resources(which)}")
    if not (fwd_err <= REL_L2_KERNEL and max(errs.values()) <= REL_L2_KERNEL
            and max(own_errs.values()) <= REL_L2_KERNEL and lse_err <= 1e-4):
        raise AssertionError(f"K2 at B={B}: forward rel L2 {fwd_err:.3e}, backward {errs} "
                             f"(vs own plain versions {own_errs}), lse {lse_err:.2e}")
    results["flash_attention"] = [dict(
        shape=f"B={B},L={L},heads={heads},hd={hd}", path="training", per_step=s["per_step"],
        ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=b_ms, flops=flops, bytes=nbytes,
        rel_l2=fwd_err, max_abs_err=fwd_mae, library_ms=lib_fwd_ms)]
    for name, which, ms, dev, plain_ms, err, mae in (
            ("flash_attention_bwd_dkv", "dkv", dkv_ms, dkv_dev_ms, plain_dkv_ms,
             max(errs["dk"], errs["dv"]), max(maes["dk"], maes["dv"])),
            ("flash_attention_bwd_dq", "dq", dq_ms, dq_dev_ms, plain_dq_ms, errs["dq"],
             maes["dq"])):
        flops, nbytes = k2_bwd_cost(s, which)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"  {name}: bound_ms={b_ms:.5f} ({b_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {b_ms / ms:.1%} of the bound (device {b_ms / dev:.1%})")
        results[name] = [dict(shape=f"B={B},L={L},heads={heads},hd={hd}", path="training",
                              per_step=s["bwd_per_step"], ms=ms, device_ms=dev,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              flops=flops, bytes=nbytes, rel_l2=err, max_abs_err=mae,
                              library_ms=lib_ms, library_device_ms=lib_dev_ms)]
    return results


def gn_census(fn):
    """Every GroupNorm call that fn() makes, in any model (one it builds
    itself too), counted by (x shape, dtype, groups, activation, shifted,
    eps, layout): `GroupNorm.forward` wrapped for the call; the layout is
    K4's as the layer's rule gives it (`kernel_layout`, NCHW where the layer
    copies x). A forward that remat reruns in the backward pass counts
    again, as it launches again."""
    from morphablediffusion_torch.models.layers import GroupNorm
    from morphablediffusion_torch.ops import group_norm as gn

    counts = {}
    forward = GroupNorm.forward

    def counted(mod, x, shift=None):
        layout = gn.kernel_layout(x)
        key = (tuple(x.shape), x.dtype, mod.num_groups, mod.act, shift is not None, mod.epsilon,
               gn.NCHW if layout is None else layout)
        counts[key] = counts.get(key, 0) + 1
        return forward(mod, x, shift)

    GroupNorm.forward = counted
    try:
        fn()
    finally:
        GroupNorm.forward = forward
    return counts


def avatar_census(model, batch, mesh=None):
    """The GroupNorm calls of one avatar: the VAE encode of
    `prepare_inference`, one denoising step (`predict_eps_cfg`; an avatar
    runs sample_steps of them) and the decode of all views (on a mesh, of
    this rank's; a mesh without a group gives a rank's calls without the
    collectives). Returns ({key: calls per avatar}, {key: calls per step})."""
    from morphablediffusion_torch.parallel.mesh import view_range

    m = model.cfg
    lo, hi = view_range(mesh, m.view_num)
    with torch.inference_mode():
        enc = gn_census(lambda: model.prepare_inference(batch))
        prep = model.prepare_inference(batch)
        step = gn_census(lambda: one_step(model, batch, prep=prep, mesh=mesh))
        lat = torch.zeros((1, hi - lo, m.latent_size, m.latent_size, 4), device=model.device)
        dec = gn_census(lambda: model.decode_views(lat))
    avatar = {}
    for counts, times in ((enc, 1), (step, m.sample_steps), (dec, 1)):
        for k, n in counts.items():
            avatar[k] = avatar.get(k, 0) + times * n
    return avatar, step


def gn_launches(counts):
    """K4's launches for the calls of a census: one per call."""
    from morphablediffusion_torch.ops import group_norm as gn

    return {gn.KERNEL.name: sum(counts.values())}


# fp32 operations per element of the GroupNorm kernel: statistics (add,
# multiply-add), the affine apply (one fma), and the activation
GN_OPS = {None: 5, "relu": 6, "silu": 9}


def gn_cost(shape, dtype, shifted, act):
    """(fp32 operations, bytes) of one GroupNorm call: x read and y written
    once, gamma and beta (fp32), the shift (in x's dtype, as the model and
    check_group_norm give it)."""
    B, C = shape[:2]
    n = math.prod(shape)
    size = torch.finfo(dtype).bits // 8
    return GN_OPS[act] * n, 2 * n * size + 8 * C + (size * B * C if shifted else 0)


def gn_plan_line(key, lib):
    """K4's plan for a census key (gn_plan, in the key's layout) with the
    clusters the card holds at once (cudaOccupancyMaxActiveClusters); the
    kernel's shared-memory layout must agree with the plan's."""
    from morphablediffusion_torch.ops import group_norm as gn

    shape, dtype, groups = key[:3]
    plan = gn.gn_plan(shape, dtype, groups, layout=key[6])
    C, S, dt = shape[1], math.prod(shape[2:]), gn._DTYPE_CODE[dtype]
    args = (C, groups, S, plan.pack, plan.cluster, plan.chunk, plan.held, plan.vec, dt,
            plan.layout)
    smem = lib.md_group_norm_smem_bytes(*args)
    if smem != plan.smem:
        raise AssertionError(f"K4 at {key}: the kernel's layout takes {smem} B, the plan "
                             f"{plan.smem} B")
    return (f"{GN_LAYOUTS[plan.layout]} cluster={plan.cluster} pack={plan.pack} "
            f"chunk={plan.chunk} held={plan.held} vec={plan.vec} grid={plan.blocks} "
            f"threads={plan.threads} smem={plan.smem} B, max active clusters "
            f"{lib.md_group_norm_max_clusters(*args)}")


def gn_span(key):
    """Bytes of one (sample, group) span of a census key's x."""
    shape, dtype, groups = key[:3]
    return shape[1] // groups * math.prod(shape[2:]) * (torch.finfo(dtype).bits // 8)


def gn_alternatives(key):
    """Other plans for a census key's call, timed beside `gn_plan`'s (never
    launched by the port): the same cluster holding 64 KiB a block, and
    holding all of its share where that fits a block, instead of 32 KiB
    and reading the rest twice; channels-last, 32 KiB, 96 KiB and all the
    rows that fit a block, beside the plan's."""
    from morphablediffusion_torch.ops import group_norm as gn

    shape, dtype, groups = key[:3]
    plan = gn.gn_plan(shape, dtype, groups, layout=key[6])
    esize = torch.finfo(dtype).bits // 8
    if plan.layout == gn.NHWC:
        C, ry = shape[1], plan.pack
        alts = []
        for held_bytes in (32 * 1024, 96 * 1024, gn.GN_MAX_SMEM):
            held = min(plan.chunk, held_bytes // (C * esize))
            smem = gn._gn_smem_nhwc(C, groups, ry, held, esize)
            while smem > gn.GN_MAX_SMEM:
                held -= 1
                smem = gn._gn_smem_nhwc(C, groups, ry, held, esize)
            if held != plan.held and held not in [a.held for a in alts]:
                alts.append(plan._replace(held=held, smem=smem))
        return alts
    if plan.pack > 1:
        return []
    alts = []
    for held_bytes in (64 * 1024, 200 * 1024):
        held = min(plan.chunk, held_bytes // (esize * plan.vec) * plan.vec)
        if held > plan.held and held not in [a.held for a in alts]:
            alts.append(plan._replace(held=held, smem=gn._gn_smem(
                shape[1] // groups, 1, held, esize)))
    return alts


def check_group_norm(censuses, device, iters: int = 10):
    """K4 against its plain version `_reference` at every GroupNorm call of
    the censuses ([(path, {key: calls})]), relative L2 1e-2, on one random
    input a shape (gamma 1 + N(0, 0.1^2), beta and shift random); and K4's
    relative L2 to GroupNorm in fp64 no more than the plain version's times
    1 + the margin, which K4 given eps x 10 (the 1e-5 / 1e-6 confusion) must
    exceed at some shape of each dtype and layout. x is laid out as the
    census found it (NCHW or channels-last). Times (per call,
    one launch) K4, the plain version and, as the yardstick, F.group_norm
    followed by the activation (one library call for the norm; the shift
    added beforehand, outside the timing), K4 and the yardstick also on the
    device alone (`queued_ms`: torch.profiler loses most records of K4's
    launches there). Logs K4's plan at each shape. The bound:
    bytes (x read and y written once) or fp32 operations at the peak
    outside the tensor cores; no share of it is given where the call moves
    less than the L2 holds. Returns one row per (path, key), per_step its
    calls there."""
    from morphablediffusion_torch.ops import group_norm as gn
    import torch.nn.functional as F

    keys = sorted({k for _, counts in censuses for k in counts},
                  key=lambda k: (-math.prod(k[0]), str(k)))
    lib = ctypes.CDLL(str(gn.KERNEL.lib_path()))
    widest = max(keys, key=gn_span)
    widest_keys = sorted(keys, key=gn_span)[-6:]  # the alternatives are timed at these
    log(f"K4 largest span: {gn_span(widest) / 2**10:.0f} KiB at x {widest[0]} "
        f"{str(widest[1])[6:]} G={widest[2]} ({gn_plan_line(widest, lib)})")
    g = torch.Generator(device).manual_seed(4)
    measured = {}
    for key in keys:
        shape, dtype, groups, act, shifted, eps, layout = key
        B, C = shape[:2]
        args = gn_inputs(key, g, device)
        x, shift, gamma, beta = args[:4]
        before = gn.KERNEL.launches
        out, plain = gn.group_norm_kernel(*args), gn._reference(*args)
        exact = gn_exact(*args)
        to_exact = [float((y.double() - exact).norm() / exact.norm()) for y in (
            out, plain, gn.group_norm_kernel(*args[:5], 10 * eps, act))]
        del exact
        if gn.KERNEL.launches != before + 2:
            raise AssertionError(f"K4 at {key}: {gn.KERNEL.launches - before} launches")
        ratio, ratio_eps10 = (d / to_exact[1] - 1 for d in (to_exact[0], to_exact[2]))
        margin = K4_MARGIN[dtype] + K4_FLIPS / math.prod(shape)
        x_lib = x if shift is None else (
            x.float() + shift.float().reshape((B, C) + (1,) * (len(shape) - 2))).to(dtype)
        gl, bl = gamma.to(dtype), beta.to(dtype)
        lib_fn = lambda: gn._ACTS[act](F.group_norm(x_lib, groups, gl, bl, eps))
        lib_err = rel_l2(lib_fn(), plain)
        torch.cuda.synchronize()
        err, mae = rel_l2(out, plain), float((out.float() - plain.float()).abs().max())
        ms = cuda_ms(lambda: gn.group_norm_kernel(*args), iters)
        plain_ms = cuda_ms(lambda: gn._reference(*args), max(2, iters // 4))
        lib_ms = cuda_ms(lib_fn, iters)
        dev_ms, lib_dev_ms = queued_ms(lambda: gn.group_norm_kernel(*args)), queued_ms(lib_fn)
        flops, nbytes = gn_cost(shape, dtype, shifted, act)
        b_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        b_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        share = (f"{b_ms / dev_ms:.1%} of the bound on the device" if nbytes > L2_BYTES else
                 "L2-resident while timed: no HBM bound")
        calls = ", ".join(f"{p} x{c[key]}" for p, c in censuses if key in c)
        alts = ", ".join(f"held {a.held * (torch.finfo(dtype).bits // 8) // 1024} KiB "
                         f"{queued_ms(lambda: gn.group_norm_kernel(*args, plan=a)):.4f}"
                         for a in (gn_alternatives(key) if key in widest_keys else []))
        alts = f"; other plans (device ms): {alts}" if alts else ""
        log(f"K4 group_norm x {shape} {GN_LAYOUTS[layout]} {str(dtype)[6:]} G={groups} act={act} "
            f"shift={shifted} eps={eps:g}: rel_l2={err:.3e} max_abs={mae:.3e}; to fp64 K4 {to_exact[0]:.6e} "
            f"plain {to_exact[1]:.6e} (ratio-1 {ratio:+.2e}, eps x10 {ratio_eps10:+.2e}, "
            f"margin {margin:.2e}) "
            f"ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} F.group_norm+act_ms={lib_ms:.4f} (device "
            f"{lib_dev_ms:.4f}; rel_l2 {lib_err:.1e}) bound_ms={b_ms:.5f} ({b_by}; "
            f"{nbytes / 1e6:.2f} MB), {share}; "
            f"{gn_plan_line(key, lib)}; calls: {calls}{alts}")
        if not (err <= REL_L2_KERNEL and lib_err <= REL_L2_KERNEL):
            raise AssertionError(f"K4 at {key}: rel L2 {err:.3e} (F.group_norm "
                                 f"{lib_err:.3e}) > {REL_L2_KERNEL}")
        if not ratio <= margin:
            raise AssertionError(f"K4 at {key}: relative L2 to fp64 {ratio:+.2e} past the "
                                 f"plain version's, margin {margin:.2e}")
        measured[key] = dict(shape=f"{shape} {GN_LAYOUTS[layout]} G={groups} {act} "
                                   f"shift={shifted}", ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             library_ms=lib_ms, library_device_ms=lib_dev_ms, flops=flops,
                             bytes=nbytes, rel_l2=err, max_abs_err=mae,
                             of_margin=ratio / margin, eps10_caught=ratio_eps10 > margin)
        del x, x_lib, out, plain, shift
    worst = max(measured.values(), key=lambda r: r["rel_l2"])
    slower = [m["shape"] for m in measured.values() if m["device_ms"] > m["library_device_ms"]]
    by_dtype = {f"{str(dt)[6:]} {GN_LAYOUTS[lay]}": (
                    max(r["of_margin"] for r in rs), sum(r["eps10_caught"] for r in rs), len(rs))
                for dt in K4_MARGIN for lay in GN_LAYOUTS
                for rs in [[measured[k] for k in keys if k[1] == dt and k[6] == lay]] if rs}
    log(f"K4 at {len(measured)} shapes: largest rel_l2 {worst['rel_l2']:.3e} at {worst['shape']}; "
        f"relative L2 to fp64 against the plain version's, per dtype and layout (largest share of "
        f"the margin, shapes where eps x10 fails the gate, shapes): {by_dtype}; on the device slower "
        f"than F.group_norm+act at "
        f"{len(slower)}: {slower}; device_ms calls that torch.profiler did not trace (timed "
        f"by queued_ms instead): {len(UNTRACED)}")
    if not all(caught for _, caught, _ in by_dtype.values()):
        raise AssertionError(f"K4's fp64 gate passes a GroupNorm given eps x10: {by_dtype}")
    rows = [dict(measured[k], path=path, per_step=n)
            for path, counts in censuses for k, n in counts.items()]
    for path, counts in censuses:
        tot = lambda f: sum(n * measured[k][f] for k, n in counts.items())
        log(f"K4 on {path}: {sum(counts.values())} calls over {len(counts)} shapes; summed "
            f"over them ms={tot('ms'):.3f} (device {tot('device_ms'):.3f}) plain_ms="
            f"{tot('plain_ms'):.3f} F.group_norm+act_ms={tot('library_ms'):.3f} (device "
            f"{tot('library_device_ms'):.3f}) bound_ms={tot('bound_ms'):.4f}")
    return rows


def gn_inputs(key, g, device):
    """GroupNorm's arguments for a census key, drawn from g: x (in the key's
    layout) and the shift N(0, 1) in x's dtype, gamma 1 + N(0, 0.1^2), beta
    N(0, 0.1^2)."""
    from morphablediffusion_torch.ops import group_norm as gn

    shape, dtype, groups, act, shifted, eps, layout = key
    B, C = shape[:2]
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    if layout == gn.NHWC:
        x = x.contiguous(memory_format=torch.channels_last)
    gamma = 1 + 0.1 * torch.randn(C, generator=g, device=device)
    beta = 0.1 * torch.randn(C, generator=g, device=device)
    shift = torch.randn(B, C, generator=g, device=device).to(dtype) if shifted else None
    return x, shift, gamma, beta, groups, eps, act


def gn_exact(x, shift, gamma, beta, groups, eps, act):
    """GroupNorm of x + shift in fp64: two-pass statistics, the affine and
    the activation."""
    from morphablediffusion_torch.ops import group_norm as gn

    B, C = x.shape[:2]
    bc = (B, C) + (1,) * (x.dim() - 2)
    xg = (x.double() + (0 if shift is None else shift.double().reshape(bc))).reshape(B, groups, -1)
    mean = xg.mean(-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(xg.var(-1, unbiased=False, keepdim=True) + eps)).reshape(x.shape)
    del xg
    return gn._ACTS[act](y * gamma.double().reshape(bc[1:]) + beta.double().reshape(bc[1:]))


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version on the card (for the
    step comparisons only; the port has no such switch). Autograd
    differentiates the plain versions."""
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa
    from morphablediffusion_torch.ops import group_norm as gn

    saved = da.ctx_attention, da.depth_attention, fa.flash_attention, gn.group_norm_shifted
    da.ctx_attention, da.depth_attention, fa.flash_attention, gn.group_norm_shifted = (
        da._ctx_reference, da._reference, fa.attention_reference, gn._reference)
    try:
        yield
    finally:
        da.ctx_attention, da.depth_attention, fa.flash_attention, gn.group_norm_shifted = saved


def one_step(model, batch, index: int = 25, prep=None, mesh=None):
    """Phase 3: one full-width CFG noise prediction at DDIM index `index`,
    from the same seeded noisy latents whatever the model's dtype; `prep`
    is model.prepare_inference(batch), made here if not given. On a mesh
    (phase 12) this rank's views of those latents, every rank's eps
    gathered in view order."""
    from morphablediffusion_torch.ops import schedules
    from morphablediffusion_torch.parallel.collectives import all_gather_cat
    from morphablediffusion_torch.parallel.mesh import view_range

    m = model.cfg
    dev = model.device
    prep = model.prepare_inference(batch) if prep is None else prep
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((1, m.view_num, m.latent_size, m.latent_size, 4), generator=g, device=dev)
    lo, hi = view_range(mesh, m.view_num)
    sched = schedules.make_diffusion_schedule(device=dev)
    ts = schedules.make_ddim_timesteps(m.sample_steps, sched.num_timesteps)
    t = torch.full((1,), int(ts[index]), dtype=torch.int64, device=dev)
    eps = model.predict_eps_cfg(x[:, lo:hi], t, prep["clip_embed"], prep["x_input"],
                                prep["v_embed"], batch, m.cfg_scale, mesh=mesh)
    eps = all_gather_cat(eps, 1, mesh)
    torch.cuda.synchronize()
    return eps


def scatter_cost(model, batch):
    """Phase 5: the mesh-voxel scatter of one serving step (one a step),
    its inputs captured from a step: device ms of the serving path's
    ordered scatter (`index_put_` with accumulate, sorted) against
    `index_add_` (atomics, which training keeps), and whether
    each gives the same bits in two calls. Returns {ordered: ms}."""
    from morphablediffusion_torch.models import mesh_voxel

    real, calls = mesh_voxel.scatter_mean_voxels, []
    mesh_voxel.scatter_mean_voxels = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
    try:
        with torch.inference_mode():
            one_step(model, batch)
    finally:
        mesh_voxel.scatter_mean_voxels = real
    if len(calls) != 1 or calls[0][0][4:] != (True,):
        raise AssertionError(f"phase 5: the serving step's scatters {[(c[0][4:], c[1]) for c in calls]}")
    feats, idx, mask, grid = calls[0][0][:4]
    out, same = {}, {}
    with torch.inference_mode():
        for ordered in (True, False):
            run = lambda: real(feats, idx, mask, grid, ordered)
            out[ordered] = device_ms(run)[0]
            a, b = run(), run()
            same[ordered] = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"phase 5 mesh-voxel scatter of a serving step ({tuple(feats.shape)} vertex features "
        f"into {tuple(grid)}): ordered {out[True]:.4f} ms device, bitwise equal twice "
        f"{same[True]}; index_add_ {out[False]:.4f} ms, bitwise equal twice {same[False]}")
    if not same[True]:
        raise AssertionError("phase 5: the ordered scatter differs between two calls")
    return out


# gradient leaves compared between the kernels and the plain versions: K1's
# q/k/v and projection weights, K3's, K2's (forward and backward), the
# frustum net that feeds K1's context, and K4's gamma and beta and the time
# projection that reaches the loss through its shift
NAMED_LEAVES = (
    "unet.out_11_cond.proj_context_conv.weight",
    "unet.out_11_cond.depth_attn.to_q.weight",
    "unet.middle_conditions.depth_attn.to_k.weight",
    "unet.in_1_attn.block_0.attn1.to_q.weight",
    "unet.in_1_attn.block_0.attn1.to_k.weight",
    "unet.in_1_attn.block_0.attn1.to_v.weight",
    "spatial_volume.frustum_volume_feats.conv0.weight",
    "unet.in_1_res.norm_out.weight",
    "unet.out_5_res.norm_in.bias",
    "unet.in_1_res.emb_proj.weight",
)


def train_expected_launches(shapes):
    """Launches per training step of each kernel, from `train_shapes` (K1's
    by design)."""
    return {**k1_launches(shapes["k1"]),
            "depth_attention": sum(s["per_step"] for s in shapes["k3"]),
            "flash_attention": shapes["k2"]["per_step"],
            "flash_attention_bwd_dkv": shapes["k2"]["bwd_per_step"],
            "flash_attention_bwd_dq": shapes["k2"]["bwd_per_step"]}


def check_train_step_vs_fp32(label, loss_and_grads, fp32_loss_and_grads, leaves, n_train, t0):
    """One bf16 training loss and backward with the kernels and with the
    plain versions, and the fp32 model's on the same draws: the loss, the
    global grad norm and each gradient leaf of `leaves` with the kernels
    no further from the fp32 model than STEP_VS_FP32_RATIO x the plain
    versions' distance plus phase 6's floor (the serving step's gate,
    `step_check`). For a path whose plain versions are deterministic, where
    phase 6's plain-vs-plain gap is 0 and leaves only its floor."""
    loss_k, norm_k, leaves_k = loss_and_grads()
    with plain_versions():
        loss_p, norm_p, leaves_p = loss_and_grads()
        loss_r, norm_r, leaves_r = loss_and_grads()
    loss_f, norm_f, leaves_f = fp32_loss_and_grads()
    rel = lambda a, b: abs(a - b) / abs(b)
    gaps = {"loss": (rel(loss_k, loss_f), rel(loss_p, loss_f), REL_TRAIN_LOSS),
            "grad norm": (rel(norm_k, norm_f), rel(norm_p, norm_f), REL_TRAIN_GRAD)}
    gaps.update({n: (rel_l2(leaves_k[n], leaves_f[n]), rel_l2(leaves_p[n], leaves_f[n]),
                     REL_TRAIN_LEAF) for n in leaves})
    bad = {n: g for n, g in gaps.items() if not g[0] <= STEP_VS_FP32_RATIO * g[1] + g[2]}
    log(f"{label} one training loss and backward, B={TRAIN_BATCH} ({n_train / 1e6:.1f} M "
        f"trainable params) against the fp32 model: loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} fp32 {loss_f:.6f}; grad norm kernels {norm_k:.5f} plain {norm_p:.5f} "
        f"fp32 {norm_f:.5f}; plain vs plain: loss rel {rel(loss_r, loss_p):.2e}, grad norm rel "
        f"{rel(norm_r, norm_p):.2e} ({time.perf_counter() - t0:.1f} s)")
    for n, (k, pl, floor) in gaps.items():
        bound = STEP_VS_FP32_RATIO * pl + floor
        vs_plain = rel_l2(leaves_k[n], leaves_p[n]) if n in leaves else 0.0
        log(f"  vs fp32: kernels {k:.3e}, plain {pl:.3e} (bound {bound:.3e}); kernels vs plain "
            f"{vs_plain:.3e}  {n}")
    if bad or not math.isfinite(loss_k):
        raise AssertionError(f"{label} training step against the fp32 model: {bad}")


def check_train_step(label, loss_and_grads, leaves, n_train, t0):
    """One bf16 training loss and backward with the kernels and twice with the
    plain versions on the same draws: the loss, the global grad norm and the
    gradient leaves named in `leaves`, each within NOISE_FACTOR x the gap
    between the two plain runs plus its floor."""
    loss_k, norm_k, leaves_k = loss_and_grads()
    with plain_versions():
        loss_p, norm_p, leaves_p = loss_and_grads()
        # the plain versions once more: how far the nondeterministic
        # backward alone moves the same numbers
        loss_r, norm_r, leaves_r = loss_and_grads()
    loss_gap = abs(loss_k - loss_p) / abs(loss_p)
    norm_gap = abs(norm_k - norm_p) / norm_p
    loss_bound = NOISE_FACTOR * abs(loss_r - loss_p) / abs(loss_p) + REL_TRAIN_LOSS
    norm_bound = NOISE_FACTOR * abs(norm_r - norm_p) / norm_p + REL_TRAIN_GRAD
    leaf_gap = {n: rel_l2(leaves_k[n], leaves_p[n]) for n in leaves}
    leaf_noise = {n: rel_l2(leaves_r[n], leaves_p[n]) for n in leaves}
    leaf_bound = {n: NOISE_FACTOR * leaf_noise[n] + REL_TRAIN_LEAF for n in leaves}
    log(f"{label} one training loss and backward, B={TRAIN_BATCH} ({n_train / 1e6:.1f} M trainable "
        f"params): loss kernels {loss_k:.6f} plain {loss_p:.6f} (rel {loss_gap:.2e}, bound "
        f"{loss_bound:.2e}); grad norm kernels {norm_k:.5f} plain {norm_p:.5f} (rel "
        f"{norm_gap:.2e}, bound {norm_bound:.2e}); plain again: loss rel "
        f"{abs(loss_r - loss_p) / abs(loss_p):.2e}, grad norm rel "
        f"{abs(norm_r - norm_p) / norm_p:.2e} ({time.perf_counter() - t0:.1f} s)")
    for n, e in leaf_gap.items():
        log(f"  grad rel_l2 kernels vs plain {e:.3e}, plain vs plain {leaf_noise[n]:.3e} "
            f"(bound {leaf_bound[n]:.3e})  {n}")
    if not (math.isfinite(loss_k) and loss_gap <= loss_bound and norm_gap <= norm_bound
            and all(leaf_gap[n] <= leaf_bound[n] for n in leaves)):
        raise AssertionError(f"{label} training step kernels vs plain: loss {loss_gap:.2e} (bound "
                             f"{loss_bound:.2e}), grad norm {norm_gap:.2e} ({norm_bound:.2e}), "
                             f"leaves {leaf_gap} (bounds {leaf_bound})")
    del leaves_k, leaves_p, leaves_r


def fp32_loss_and_grads(cfg, model, batch, draws, leaves):
    """The training loss, global grad norm and `leaves`' gradients of the fp32
    model (the same weights, fp32 compute, plain versions) on the same
    draws; its VAE and CLIP take no gradient, as in the Trainer."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion

    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    model32 = MorphableDiffusion(cfg32.model, device=model.device).train()
    model32.load_state_dict(model.state_dict())
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    for n, p in model32.named_parameters():
        p.requires_grad_(n in trainable)
    with plain_versions():
        loss = model32.training_loss(batch, draws=draws)
        loss.backward()
    params = dict(model32.named_parameters())
    norm = torch.sqrt(sum(params[n].grad.float().pow(2).sum() for n in trainable
                          if params[n].grad is not None))
    out = float(loss.detach()), float(norm), {n: params[n].grad.float().clone() for n in leaves}
    del model32, params, loss
    torch.cuda.empty_cache()
    return out


def train_phase(cfg, device, kernels, expected, steps: int = TRAIN_STEPS, warmup: int = 2,
                label: str = "phase 6", check: Optional[str] = "plain", leaves=NAMED_LEAVES,
                profile: bool = True):
    """Phase 6 (and 9d): full-width training steps on the port's Trainer,
    after one loss and backward with the kernels and with the plain
    versions, compared on `leaves` by `check_train_step` (check "plain") or
    `check_train_step_vs_fp32` ("fp32"), or not (None). `expected` holds
    the launches per step of every kernel but K4's, whose come from the
    GroupNorm census of the first warm-up step. Returns the launch counts of
    the timed run, its ms per step, the peak memory and the census."""
    from morphablediffusion_torch.training.trainer import Trainer

    B = TRAIN_BATCH
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device, seed=0)
    model = trainer.model
    batch = flagship_batch(cfg, device, seed=2, B=B, with_targets=True)
    n_train = sum(p.numel() for _, p in trainer.grad_params())
    draws = model.draw_training_noise(B, torch.Generator(device).manual_seed(11))
    params = dict(model.named_parameters())

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model.training_loss(batch, draws=draws)
        loss.backward()
        torch.cuda.synchronize()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for _, p in trainer.grad_params() if p.grad is not None))
        return (float(loss.detach()), float(norm),
                {n: params[n].grad.float().clone() for n in leaves})

    if check == "plain":
        check_train_step(label, loss_and_grads, leaves, n_train, t0)
    elif check == "fp32":
        check_train_step_vs_fp32(label, loss_and_grads,
                                 lambda: fp32_loss_and_grads(cfg, model, batch, draws, leaves),
                                 leaves, n_train, t0)
    model.zero_grad(set_to_none=True)

    before = {n: params[n].detach().float().clone() for n in leaves}
    census = gn_census(lambda: trainer.train_step(batch))
    expected = dict(expected, **gn_launches(census))
    for _ in range(warmup - 1):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    losses = [trainer.train_step(batch)["loss"] for _ in range(steps)]
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k.name: k.launches for k in kernels}
    ms = ev0.elapsed_time(ev1) / steps
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    moved = [n for n in leaves if not torch.equal(before[n], params[n].detach().float())]
    log(f"{label} training: {ms:.2f} ms per step (CUDA events, mean of {steps} after "
        f"{warmup} warm-up), {host_ms:.2f} ms host clock; {B / ms * 1e3:.3f} samples/s; peak "
        f"allocated {peak / 2**30:.2f} GiB; losses {[round(x, 5) for x in losses]}; "
        f"launches over {steps} steps {launches} (expected per step {expected})")
    if not all(math.isfinite(x) for x in losses) or len(moved) != len(leaves):
        raise AssertionError(f"{label} training: losses {losses}, parameters moved {moved}")
    if launches != {n: steps * c for n, c in expected.items()}:
        raise AssertionError(f"{label} training launch counts {launches}, expected {steps} x "
                             f"{expected}")
    if profile:
        profile_report(f"{label} one profiled training step", lambda: trainer.train_step(batch))
    return launches, ms, peak, census


def kernel_entry(name, source, replaces, rows, launches, path, run, train_per_step,
                 peak_flops: float = PEAK_BF16_FLOPS, list_shapes: bool = True):
    """One kernel of the kernels line. ms, plain_ms, bound_ms and
    library_ms are per launch (every kernel launches once a call),
    averaged over the launch mix of the rows of `path` (serving or
    training), the path of `run`, the run that counted `launches` (the
    avatar or the timed training steps): launches * ms is the kernel's time
    there. train_per_step is
    its launches per training step, counted in the timed training steps.
    Every row is listed under shapes (per call, per_step its calls), or
    with list_shapes=False (K4's hundreds of rows, which its log lines
    give) only counted."""
    mix = [r for r in rows if r["path"] == path]
    n = sum(r["per_step"] for r in mix)
    mean = lambda key: sum(r["per_step"] * r[key] for r in mix) / n
    flops, nbytes = mean("flops"), mean("bytes")
    lib = mix[0].get("library_ms")
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if flops / peak_flops >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": None if lib is None else mean("library_ms"),
        "run": run, "train_launches_per_step": train_per_step,
        "max_rel_l2": max(r["rel_l2"] for r in rows), "shape_rows": len(rows),
    }
    if list_shapes:
        entry["shapes"] = [{k: r[k] for k in ("shape", "path", "per_step", "ms", "device_ms",
                                              "plain_ms", "bound_ms", "rel_l2", "design")
                            if k in r} for r in rows]
    return entry


# phase 3's steps by label: (kernels, plain versions, fp32 model), on the host
STEP_EPS = {}


def step_check(cfg, device, label: str):
    """Phase 3 (and 7): one full-width step of `cfg` in bf16 with the
    kernels and with the plain versions, and of the fp32 model (same seeded
    weights, plain versions); the kernels' step must be finite, within
    REL_L2_STEP of the plain one and no further from the fp32 model than
    STEP_VS_FP32_RATIO x the plain bf16 step. Returns the serving model, the
    batch and the kernels' step time in ms (CUDA events, the mean of 3
    steps after a warm one, prepare_inference excluded)."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.weights import seeded_params

    t0 = time.perf_counter()
    model = serving_model(cfg, device, seed=0)
    batch = flagship_batch(cfg, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    model32 = seeded_params(MorphableDiffusion(cfg32.model, device=device), 0).eval()
    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        eps = one_step(model, batch, prep=prep)
        step_ms = cuda_ms(lambda: one_step(model, batch, prep=prep), 3, warmup=0)
        with plain_versions():
            eps_plain = one_step(model, batch, prep=prep)
            eps32 = one_step(model32, batch)
    del model32
    torch.cuda.empty_cache()
    STEP_EPS[label] = (eps.cpu(), eps_plain.cpu(), eps32.cpu())  # for phase 12 (b)
    step_err = rel_l2(eps, eps_plain)
    err_k, err_p = rel_l2(eps, eps32), rel_l2(eps_plain, eps32)
    log(f"{label} one predict_eps_cfg step ({n_params / 1e6:.1f} M params): eps "
        f"{tuple(eps.shape)} rel_l2 kernels vs plain = {step_err:.3e}; vs the fp32 "
        f"model: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; kernels' step {step_ms:.2f} ms "
        f"(CUDA events, mean of 3) ({time.perf_counter() - t0:.1f} s)")
    if (not torch.isfinite(eps).all() or not step_err <= REL_L2_STEP
            or not err_k <= STEP_VS_FP32_RATIO * err_p):
        raise AssertionError(f"{label} step: finite={bool(torch.isfinite(eps).all())} "
                             f"rel L2 {step_err:.3e} (bound {REL_L2_STEP}); vs fp32 "
                             f"{err_k:.3e} (bound {STEP_VS_FP32_RATIO} x {err_p:.3e})")
    return model, batch, step_ms


def timed_avatar(sampler, batch, kernels, want, label: str, warmup: bool = True):
    """Phase 4 (and 7): an optional warm-up avatar, then one timed avatar
    with every launch counter set to 0 just before it, both from a generator
    seeded with 1 (the same noise). The launches must be `want`, the images
    finite, not constant and of the config's shape, and with a warm-up the
    two avatars' latents and images equal to the bit (the serving path
    scatters its mesh voxels in order). Returns (seconds by CUDA events,
    peak bytes, launches)."""
    cfg = sampler.model.cfg
    seeded = lambda: torch.Generator(sampler.model.device).manual_seed(1)
    if warmup:
        t0 = time.perf_counter()
        first = sampler.sample(batch, cfg.cfg_scale, generator=seeded())
        torch.cuda.synchronize()
        log(f"{label} warm-up avatar: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    images, latents = sampler.sample(batch, cfg.cfg_scale, generator=seeded())
    ev1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    seconds = ev0.elapsed_time(ev1) / 1e3
    log(f"{label} avatar: {seconds:.3f} s (CUDA events), {host_s:.3f} s host clock; peak "
        f"allocated {peak / 2**30:.2f} GiB; launches {launches} (expected {want})")
    shape = (1, cfg.view_num, cfg.image_size, cfg.image_size, 3)
    finite = bool(torch.isfinite(images).all())
    spread = float(images.float().std())
    log(f"  images {tuple(images.shape)} finite={finite} std={spread:.4f} "
        f"mean={float(images.float().mean()):.4f}; latents {tuple(latents.shape)}")
    if tuple(images.shape) != shape or not finite or not spread > 0:
        raise AssertionError(f"{label}: the avatar's images are not finite, non-constant "
                             f"and of shape {shape}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected {want}")
    if warmup:
        same = torch.equal(first[0], images) and torch.equal(first[1], latents)
        log(f"  the warm-up and the timed avatar (the same seed) bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{label}: two avatars of one seed differ (images "
                                 f"{rel_l2(images, first[0]):.3e}, latents "
                                 f"{rel_l2(latents, first[1]):.3e})")
    return seconds, peak, launches


def avatar_launches(kernels, cfg, k1_shapes, k2_shape, gn_counts):
    """Launches of every kernel in one serving avatar: K1 (by design) and K2
    per step (main_path_shapes) times the steps, K3 at the unfused
    DepthTransformers (none under `Config()`), K4 per GroupNorm call of the
    census, none of the backward kernels."""
    want = {k.name: 0 for k in kernels}
    steps = cfg.model.sample_steps
    want.update({n: steps * c for n, c in k1_launches(k1_shapes).items()},
                flash_attention=steps * k2_shape["per_step"],
                depth_attention=steps * sum(
                    s["per_step"] for s in serving_k3_shapes(cfg, cfg.model.view_num)),
                **gn_launches(gn_counts))
    return want


def other_configs():
    """Phase 7's configurations at full width: label -> Config."""
    from morphablediffusion_torch.utils.config import _THUMAN_DEFAULTS, Config

    thuman, fine, spatial = Config(), Config(), Config()
    thuman.data.dataset = "thuman"
    thuman.model = dataclasses.replace(thuman.model, **_THUMAN_DEFAULTS)
    fine.model.mesh_voxel_mode = "fine"  # grid (128, 144, 128) at 0.005 m
    spatial.model.use_spatial_volume = True
    return {"thuman": thuman, "fine": fine, "spatial_volume": spatial}


def cli_entry():
    """Phase 8's way into the CLI: `main([...])` where PIL and PyYAML import
    (the CLI reads images and the YAML config with them), else `run(...)`."""
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "yaml")}
    use_main = all(have.values())
    log(f"phase 8 PIL/PyYAML probe: {have}: the CLI through "
        f"{'main([...]), as a user runs it' if use_main else 'run(...) with Config()'}")
    return use_main


def cli_avatar(use_main: bool, out: Path, image: str, mesh: str, ckpt: str, extra=()):
    """One avatar of the generate_face CLI: main(argv) writing into `out`,
    or, without PIL or PyYAML, run(...) on Config() with flagship_batch's
    input image (the flags of `extra` that matter there applied by hand).
    Returns (views, report)."""
    from morphablediffusion_torch.apps import generate_face as gf

    if use_main:
        return gf.main(["--input_img", image, "--mesh", mesh, "--cfg", CLI_CONFIG,
                        "--ckpt", ckpt, "--output_dir", str(out), *extra])
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices
    from morphablediffusion_torch.utils.torch_import import load_torch_state_dict

    cfg = Config()
    cfg.model.unet.w8a8 = "--w8a8" in extra
    verts = load_mesh_vertices(mesh)
    if "--no_mica_alignment" not in extra:
        verts = gf.align_mica_mesh(verts)
    state_dict = None
    if ckpt.endswith(gf.REFERENCE_SUFFIXES):
        state_dict = load_torch_state_dict(ckpt)
        gf.autoselect_fine_conditioner(cfg.model, state_dict, verts)
    Ks, RTs = gf.generate_camera_trajectory(cfg.model.view_num)
    img = flagship_batch(cfg, "cpu")["input_image"][0].numpy()
    return gf.run(cfg, img, Ks, RTs, verts, ckpt, state_dict=state_dict)


def port_name(path: str) -> str:
    """flax path below 'params' -> the port's parameter name."""
    parts = path.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts[:-1] + [leaf])


def write_cli_checkpoint(device, path: Path):
    """Phase 8 (a): the fine model (grid cropped to demo/mesh.obj) with seeded
    weights (seed 0), exported as a flagship-width reference-named fp16
    checkpoint; the importer must give back every tensor of the file as the
    fp16-rounded seeded one and leave every other parameter as it is.
    Returns (tensors in the file, the model's GroupNorm census per avatar,
    the fine model's config)."""
    from morphablediffusion_torch.apps import generate_face as gf
    from morphablediffusion_torch.utils import torch_import as ti
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices
    from morphablediffusion_torch.weights import cast_for_serving

    cfg = Config()
    verts = load_mesh_vertices(CLI_MESH)
    gf.autoselect_fine_conditioner(cfg.model, {"spatial_volume.xyzc_net.": None}, verts)
    if tuple(cfg.model.fine_grid_shape) != CLI_FINE_GRID:
        raise AssertionError(f"fine grid {cfg.model.fine_grid_shape} != {CLI_FINE_GRID}")
    t0 = time.perf_counter()
    model = serving_model(cfg, device, seed=0, cast=False)
    seeded = {n: p.detach().clone() for n, p in model.named_parameters()}
    t1 = time.perf_counter()
    n = ti.export_torch_checkpoint(model, path, dtype=torch.float16)
    t2 = time.perf_counter()
    state_dict = ti.load_torch_state_dict(path)
    report = ti.import_state_dict(state_dict, model, clip_layers=cfg.model.clip.layers)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    mapped = {port_name(opath) for tkey, opath, _ in
              ti.full_mapping(cfg.model.clip.layers) + ti.xyzc_mapping() if tkey in state_dict}
    del state_dict
    bad = [name for name, p in model.named_parameters()
           if not torch.equal(p, seeded[name].half().float() if name in mapped else seeded[name])]
    log(f"phase 8 (a) checkpoint: {n} fp16 tensors, {path.stat().st_size / 2**30:.2f} GiB "
        f"({sum(p.numel() for p in seeded.values()) / 1e6:.1f} M params; seeded fine model "
        f"{t1 - t0:.1f} s, export {t2 - t1:.1f} s, read and import {t3 - t2:.1f} s); import "
        f"report: filled {report['filled']}, {len(report['unused_torch_keys'])} unused, "
        f"{len(report['unmatched_model_paths'])} unmatched; imported parameters equal to the "
        f"fp16-rounded seeded ones: {len(mapped) - len(set(bad) & mapped)} of {len(mapped)}, "
        f"the others untouched: {len(seeded) - len(mapped) - len(set(bad) - mapped)} of "
        f"{len(seeded) - len(mapped)}")
    if (bad or report["filled"] != n or report["unused_torch_keys"]
            or report["unmatched_model_paths"] or len(mapped) != n):
        raise AssertionError(f"phase 8 (a): import report {report}, {n} tensors, parameters "
                             f"that differ {bad[:5]}")
    del seeded
    census, _ = avatar_census(cast_for_serving(model).eval(), flagship_batch(cfg, device))
    del model
    torch.cuda.empty_cache()
    return n, census, cfg


def check_cli_avatar(label, cfg, views, report, launches, want, out: Optional[Path],
                     stem: str, neus2: bool):
    """Phase 8 (b), (c): launches, views, files and the CLI's seconds."""
    N, S = cfg.model.view_num, cfg.model.image_size
    finite = bool(np.isfinite(views).all())
    spread = float(views.std())
    log(f"{label}: seconds {', '.join(f'{k} {v:.3f}' for k, v in report['seconds'].items())} "
        f"(sample by CUDA events, the first avatar of its process); conditioner "
        f"{report['mesh_voxel_mode']} {report['fine_grid_shape']}, w8a8 {report['w8a8']}; "
        f"views {views.shape} finite={finite} std={spread:.4f}; launches {launches} (expected "
        f"{want})")
    if views.shape != (N, S, S, 3) or not finite or not spread > 0:
        raise AssertionError(f"{label}: views {views.shape} finite={finite} std={spread}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected {want}")
    if out is None:
        return
    from PIL import Image

    strip = np.asarray(Image.open(out / f"{stem}_mesh.png"))
    files = {"strip": strip.shape}
    if neus2:
        root = out / "neus2_data" / f"{stem}_mesh"
        frames = json.loads((root / "transform.json").read_text())["frames"]
        shapes = {np.asarray(Image.open(root / f["file_path"])).shape for f in frames}
        files.update(frames=len(frames), views=shapes)
        if len(frames) != N or shapes != {(S, S, 4)}:
            raise AssertionError(f"{label}: NeuS2 data {files}")
    log(f"  files: {files}")
    if strip.shape != (S, S * (N + 1), 3):
        raise AssertionError(f"{label}: strip {strip.shape}")


@contextlib.contextmanager
def int8_conv_ranges():
    """Mark every W8A8 conv as a profiler range `conv2d_w8a8` (for the one
    profiled W8A8 step only; the port has no such marks)."""
    from torch.profiler import record_function

    from morphablediffusion_torch.ops import int8 as q8

    conv = q8.conv2d_w8a8

    def marked(*args, **kwargs):
        with record_function("conv2d_w8a8"):
            return conv(*args, **kwargs)

    q8.conv2d_w8a8 = marked
    try:
        yield
    finally:
        q8.conv2d_w8a8 = conv


def w8a8_profile(device):
    """Phase 8 (d): one profiled W8A8 denoising step of Config()'s seeded
    weights: the int8 convs' device time. (The bf16-vs-W8A8 drift over 50
    steps is phase 13 (c)'s, through int8_trajectory, at the same gates.)"""
    from morphablediffusion_torch.ops import schedules
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils.config import Config

    cfg = Config()
    cfg.model.unet.w8a8 = True
    batch = flagship_batch(cfg, device, seed=0)
    model = serving_model(cfg, device, seed=0)
    sampler = SyncDDIMSampler(model, sample_steps=W8A8_STEPS)
    m = model.cfg
    g = torch.Generator(device).manual_seed(5)
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    x, noise = (torch.randn(shape, generator=g, device=device) for _ in range(2))
    t = torch.full((1,), int(sampler.timesteps[25]), dtype=torch.int64, device=device)
    with torch.inference_mode(), int8_conv_ranges():
        prep = model.prepare_inference(batch)
        prof = profile_report("phase 8 (d) one profiled W8A8 denoising step",
                              lambda: schedules.ddim_step(
                                  x, model.predict_eps_cfg(
                                      x, t, prep["clip_embed"], prep["x_input"],
                                      prep["v_embed"], batch, m.cfg_scale),
                                  25, sampler.ddim, noise))
    marks = [e for e in prof.events() if e.name == "conv2d_w8a8"
             and e.device_type == torch.autograd.DeviceType.CPU]
    int8_ms = sum(e.device_time_total for e in marks) / 1e3
    mm_ms = sum(e.device_time_total for e in prof.events() if e.name == "aten::_int_mm"
                and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    log(f"phase 8 (d) int8 convs in one W8A8 step: {len(marks)} calls, {int8_ms:.3f} ms "
        f"of device time (quantize, im2col, _int_mm, dequantize), of which _int_mm "
        f"{mm_ms:.3f} ms")
    del sampler, prep, model
    torch.cuda.empty_cache()


def cli_phase(device, kernels, k1_shapes, k2_shape, serving_census):
    """Phase 8: the generate_face CLI ((a) - (d) in the module docstring).
    `serving_census` is phase 3's GroupNorm census of Config()'s avatar,
    which the W8A8 CLI avatar shares (same shapes). Returns the fine
    avatar's census for K4's check."""
    from morphablediffusion_torch.utils.config import Config

    t_phase = time.perf_counter()
    use_main = cli_entry()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "flagship_fine.ckpt"
        n, fine_census, fine_cfg = write_cli_checkpoint(device, ckpt)
        runs = (
            ("phase 8 (b) the documented run", CLI_INPUT, CLI_MESH, str(ckpt),
             ("--no_mica_alignment", "--prepare_neus2_data"), fine_cfg, fine_census),
            ("phase 8 (c) photo, PLY, random weights, W8A8", CLI_PHOTO, CLI_PLY, "random",
             ("--w8a8",), Config(), serving_census))
        for label, image, mesh, ck, extra, cfg, census in runs:
            out = tmp / label.split()[2].strip("()")
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            views, report = cli_avatar(use_main, out, image, mesh, ck, extra)
            host_s = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            want = avatar_launches(kernels, cfg, k1_shapes, k2_shape, census)
            log(f"{label}: {host_s:.2f} s host clock for the whole CLI call")
            check_cli_avatar(label, cfg, views, report, launches, want,
                             out if use_main else None,
                             Path(image).stem, "--prepare_neus2_data" in extra)
            if ck == str(ckpt):
                imp = report["import"]
                log(f"  import report: filled {imp['filled']} of the file's {n} tensors, "
                    f"{len(imp['unused_torch_keys'])} unused, "
                    f"{len(imp['unmatched_model_paths'])} unmatched; fine grid "
                    f"{report['fine_grid_shape']}")
                if (imp["filled"] != n or imp["unused_torch_keys"]
                        or imp["unmatched_model_paths"]
                        or report["fine_grid_shape"] != CLI_FINE_GRID
                        or report["mesh_voxel_mode"] != "fine"):
                    raise AssertionError(f"{label}: report {report}")
            del views
            torch.cuda.empty_cache()
    w8a8_profile(device)
    log(f"phase 8 the generate_face CLI: {time.perf_counter() - t_phase:.1f} s")
    return fine_census


# phase 9: the from-scratch recipe (configs/synth_scratch.yaml) and the other
# training configurations. The synthetic tree: subjects 1-4 train, 5
# validates, two expressions each, 16 views at 128^2 (synth_scratch's size)
SYNTH_CONFIG = ROOT / "configs/synth_scratch.yaml"
SYNTH_SUBJECTS, SYNTH_EXPRESSIONS, SYNTH_VIEWS, SYNTH_SIZE = 5, 2, 16, 128
VAE_STEPS, VAE_LOG_EVERY = 40, 10  # train_vae at the CLI's defaults otherwise
SYNTH_STEPS = 4  # train.py steps on synth_scratch; the last one validates
SYNTH_VAL_STEPS = 10  # its validation avatar's sampler steps (the config's 50: a depth cut)
CONFIG_STEPS = 3  # timed training steps of each other configuration, after 1 warm-up
# decode(encode(x)) of the train_vae file against the same weights before the
# latent fold, fp32 (the fold moves only rounding)
REL_L2_FOLD = 1e-4
# z * 0.18215 of the folded VAE on a fresh batch: about unit-variance
FOLD_STD_RANGE = (0.5, 2.0)
# the fine conditioner's phase-9 leaves besides NAMED_LEAVES: the reference's
# xyzc_net (its first conv and a BatchNorm's trained running mean)
FINE_LEAVES = NAMED_LEAVES + ("spatial_volume.mesh_voxel.net.conv0_0.weight",
                              "spatial_volume.mesh_voxel.net.conv2_7.mean")


class _Tee:
    """stdout for a CLI's main: printed through and kept."""

    def __init__(self):
        self.lines = []

    def write(self, text):
        sys.__stdout__.write(text)
        self.lines.append(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self) -> str:
        return "".join(self.lines)


def run_cli(main_fn, argv):
    """main_fn(argv) with its stdout printed and returned, and its host
    seconds (ending in a device synchronize)."""
    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        main_fn(argv)
    torch.cuda.synchronize()
    return tee.text(), time.perf_counter() - t0


def synthetic_tree(root: Path):
    """Phase 9a: the port's synthetic FaceScape tool."""
    from morphablediffusion_torch.tools import make_synthetic_facescape

    _, seconds = run_cli(make_synthetic_facescape.main, [
        "--out", str(root), "--subjects", str(SYNTH_SUBJECTS), "--expressions",
        str(SYNTH_EXPRESSIONS), "--views", str(SYNTH_VIEWS), "--image_size", str(SYNTH_SIZE)])
    pngs = len(list((root / "data").rglob("*.png")))
    log(f"phase 9a synthetic data: {pngs} views of {SYNTH_SIZE}^2 under {root} "
        f"({seconds:.1f} s)")
    if pngs != SYNTH_SUBJECTS * SYNTH_EXPRESSIONS * SYNTH_VIEWS:
        raise AssertionError(f"phase 9a: {pngs} pngs written")


def vae_phase(data: Path, out: Path, device, kernels, card: str):
    """Phase 9b: `train_vae.main` at the CLI's defaults for VAE_STEPS steps:
    the loss finite and falling, K4 launched once per GroupNorm call (the
    census of one step and of the fold's encodes; no other kernel), the
    file's meta keys, and the fold. Returns the GroupNorm census of a step."""
    from morphablediffusion_torch.apps import train_vae
    from morphablediffusion_torch.models.diffusion import FIRST_STAGE_SCALE
    from morphablediffusion_torch.ops import group_norm as gn

    meta = dict(ch=32, ch_mult=[1, 2, 2, 4], num_res_blocks=1, image_size=SYNTH_SIZE)
    B = 16
    probe = train_vae.build_vae(meta, device)
    x = torch.rand((B, 3, SYNTH_SIZE, SYNTH_SIZE), device=device) * 2 - 1
    eps = torch.randn((B, 4, SYNTH_SIZE // 8, SYNTH_SIZE // 8), device=device)
    step = gn_census(lambda: train_vae.vae_loss(probe, x, eps, 1e-6)[0].backward())
    with torch.no_grad():
        enc = gn_census(lambda: probe.encode_moments(x))
    del probe
    for k in kernels:
        k.launches = 0
    text, seconds = run_cli(train_vae.main, [
        "--data_dir", str(data), "--out", str(out), "--steps", str(VAE_STEPS),
        "--log_every", str(VAE_LOG_EVERY)])
    launches = {k.name: k.launches for k in kernels}
    rows = re.findall(r"step (\d+) loss ([-\d.e+naif]+) .* (\d+) ms/step", text)
    losses = [float(r[1]) for r in rows]
    want = {k.name: 0 for k in kernels}
    want[gn.KERNEL.name] = VAE_STEPS * sum(step.values()) + 4 * sum(enc.values())
    log(f"phase 9b train_vae: {VAE_STEPS} steps of B={B} at {SYNTH_SIZE}^2 in {seconds:.1f} s "
        f"(host clock, nvcc excluded); ms/step by window of {VAE_LOG_EVERY} "
        f"{[int(r[2]) for r in rows]} ({card}); losses {losses}; K4 {sum(step.values())} "
        f"launches a step over {len(step)} shapes (one channel a group: "
        f"{sorted({k[0] for k in step if k[0][1] == k[2]})}); launches {launches}")
    if not (losses and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 9b: losses {losses} not finite and falling")
    if launches != want:
        raise AssertionError(f"phase 9b: launches {launches}, expected {want}")
    state, meta_out = train_vae.load_vae(str(out))
    keys = {"ch", "ch_mult", "num_res_blocks", "image_size", "latent_std_raw", "fold_scale"}
    if set(meta_out) != keys:
        raise AssertionError(f"phase 9b: meta keys {sorted(meta_out)}, expected {sorted(keys)}")
    folded = train_vae.build_vae(meta_out, device, dtype=torch.float32)
    folded.load_state_dict(state)
    unfolded = train_vae.build_vae(meta_out, device, dtype=torch.float32)
    unfolded.load_state_dict(train_vae.fold_latent_scale(state, 1.0 / meta_out["fold_scale"]))
    ds = train_vae.ImageFolderDataset(str(data), SYNTH_SIZE)
    imgs = train_vae.to_images({"image": np.stack([ds[i]["image"] for i in range(B)])}, device)
    with torch.no_grad():
        mean, _ = folded.encode_moments(imgs)
        rec = folded.decode(mean)
        rec0 = unfolded.decode(unfolded.encode_moments(imgs)[0])
    err, std = rel_l2(rec, rec0), float((mean * FIRST_STAGE_SCALE).std())
    log(f"  fold x{meta_out['fold_scale']:.4f} (latent std {meta_out['latent_std_raw']:.4f}): "
        f"decode(encode(x)) after vs before rel_l2 {err:.3e} (bound {REL_L2_FOLD}); "
        f"std of z*{FIRST_STAGE_SCALE} {std:.4f} (range {FOLD_STD_RANGE}); recon vs input "
        f"rel_l2 {rel_l2(rec, imgs):.4f}")
    if not (err <= REL_L2_FOLD and FOLD_STD_RANGE[0] <= std <= FOLD_STD_RANGE[1]):
        raise AssertionError(f"phase 9b: fold rel L2 {err:.3e}, latent std {std:.4f}")
    return step


def synth_config(root: Path, tmp: Path):
    """A copy of configs/synth_scratch.yaml on the synthetic tree, validating
    at its last step with SYNTH_VAL_STEPS sampler steps, logging every step:
    (path, the port's Config)."""
    import yaml

    from morphablediffusion_torch.utils.config import load_config

    raw = yaml.safe_load(SYNTH_CONFIG.read_text())
    uid = lambda s, e: f"{s:03d}/{e:02d}"
    raw["data"].update(
        data_dir=str(root / "data"), flame_assets_dir=str(root / "flame"),
        uids=[uid(s, e) for s in range(1, SYNTH_SUBJECTS) for e in range(1, 3)],
        val_uids=[uid(SYNTH_SUBJECTS, e) for e in range(1, 3)], num_workers=4)
    raw["train"].update(val_check_interval=SYNTH_STEPS, log_every=1)
    raw["model"]["sample_steps"] = SYNTH_VAL_STEPS
    path = tmp / "synth_scratch.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path, load_config(path)


def synth_phase(root: Path, vae_file: Path, tmp: Path, device, kernels, checked, card: str):
    """Phase 9c: `train.main` on synth_scratch with --vae_from, SYNTH_STEPS
    steps and the validation avatar at the last. Launches per training step
    (K1 by design, K3, no K2) and of the avatar, K4 once per GroupNorm call;
    the graft; the contact sheet. Phase 2 at its new shapes first (9e).
    Returns the GroupNorm census of the run."""
    from PIL import Image

    from morphablediffusion_torch.apps import train
    from morphablediffusion_torch.apps.train_vae import load_vae
    from morphablediffusion_torch.ops import group_norm as gn
    from morphablediffusion_torch.sampling import SyncDDIMSampler

    path, cfg = synth_config(root, tmp)
    m = cfg.model
    B_train, B_val = cfg.data.batch_size, m.output_num * m.batch_view_num
    chunks = m.view_num // m.batch_view_num
    tshapes = train_shapes(cfg, B_train)
    k1_val = [{k: v for k, v in s.items() if k != "fused"}
              for s in depth_blocks(cfg, B_val, train=False) if s["fused"]]
    k3_val = serving_k3_shapes(cfg, B_val)

    # 9e: the kernels against their plain versions at synth_scratch's shapes
    g = torch.Generator(device).manual_seed(9)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    with torch.no_grad():
        for path_name, k1s, k3s in (("synth serving", k1_val, k3_val),
                                    ("synth training", tshapes["k1"], tshapes["k3"])):
            for name, rows in check_k1(k1s, device, rn, 10, path_name).items():
                checked[name] = checked.get(name, []) + rows
            checked["depth_attention"] += check_k3(
                [s for s in k3s if s["per_step"]], device, rn, 10, path_name)

    expected = train_expected_launches(tshapes)
    val_want = {n: m.sample_steps * chunks * c for n, c in k1_launches(k1_val).items()}
    val_want["depth_attention"] = m.sample_steps * chunks * sum(s["per_step"] for s in k3_val)
    val = {}
    sample = SyncDDIMSampler.sample

    def timed_sample(self, *args, **kwargs):
        torch.cuda.synchronize()
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = sample(self, *args, **kwargs)
        torch.cuda.synchronize()
        val["seconds"] = time.perf_counter() - t0
        val["launches"] = {k.name: k.launches - before[k.name] for k in kernels}
        return out

    for k in kernels:
        k.launches = 0
    run_dir = tmp / "runs" / "synth"
    cli = {}

    def run_train():
        cli["out"] = run_cli(train.main, ["-b", str(path), "-l", str(tmp / "runs"), "-n", "synth",
                                          "--vae_from", str(vae_file), "--max_steps",
                                          str(SYNTH_STEPS)])

    SyncDDIMSampler.sample = timed_sample
    try:
        census = gn_census(run_train)
    finally:
        SyncDDIMSampler.sample = sample
    text, seconds = cli["out"]
    launches = {k.name: k.launches for k in kernels}
    train_launches = {n: c - val["launches"][n] for n, c in launches.items()}
    step_ms = [int(v) for v in re.findall(r"step \d+ loss .* (\d+) ms/step", text)]
    losses = [float(v) for v in re.findall(r"step \d+ loss ([-\d.e+naif]+)", text)]
    want_train = {n: SYNTH_STEPS * expected.get(n, 0) for n in launches}
    want_train[gn.KERNEL.name] = train_launches[gn.KERNEL.name]
    val_want = {n: val_want.get(n, 0) for n in launches}
    val_want[gn.KERNEL.name] = val["launches"][gn.KERNEL.name]
    log(f"phase 9c train.py on synth_scratch: {SYNTH_STEPS} steps of B={B_train} then the "
        f"validation avatar ({m.output_num} samples x {m.view_num} views, {chunks} chunks of "
        f"{m.batch_view_num} views, {m.sample_steps} steps) in {seconds:.1f} s; ms/step (host "
        f"clock) {step_ms} ({card}); validation avatar {val['seconds']:.2f} s; losses {losses}")
    log(f"  launches per training step {({n: c / SYNTH_STEPS for n, c in train_launches.items()})}"
        f" (expected {expected}); avatar {val['launches']} (expected {val_want}); K4 "
        f"{launches[gn.KERNEL.name]} launches for {sum(census.values())} GroupNorm calls")
    if train_launches != want_train or val["launches"] != val_want:
        raise AssertionError(f"phase 9c: launches training {train_launches} (expected "
                             f"{want_train}), avatar {val['launches']} (expected {val_want})")
    if launches[gn.KERNEL.name] != sum(census.values()):
        raise AssertionError(f"phase 9c: K4 launched {launches[gn.KERNEL.name]} times for "
                             f"{sum(census.values())} GroupNorm calls")
    if len(losses) != SYNTH_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 9c: losses {losses}")
    state, _ = load_vae(str(vae_file))
    params = torch.load(run_dir / "ckpt" / "params" / "params.pt", map_location="cpu")
    bad = [k for k, v in state.items()
           if not torch.equal(params[f"first_stage.{k}"], v.to(params[f"first_stage.{k}"].dtype))]
    sheet = np.asarray(Image.open(run_dir / "images" / "val" / f"{SYNTH_STEPS}.jpg"), np.float32)
    log(f"  graft: {len(state) - len(bad)} of {len(state)} first_stage tensors equal the "
        f"train_vae file's; contact sheet {sheet.shape} std {sheet.std():.2f}")
    if bad or not (np.isfinite(sheet).all() and sheet.std() > 0):
        raise AssertionError(f"phase 9c: first_stage differs at {bad[:5]} or the contact sheet "
                             "is constant")
    return census


def training_complete(device, kernels, checked, card: str, keep: Path):
    """Phase 9: the from-scratch recipe (a - c, with e: phase 2 at its new
    shapes) and full-width training under THuman, the fine conditioner and
    use_spatial_volume (d). Its tree, run and config stay under
    `keep`/phase9 for phase 13 (f). Returns the GroupNorm censuses for K4's
    check."""
    t_phase = time.perf_counter()
    censuses = []
    tmp = keep / "phase9"
    tmp.mkdir()
    root = tmp / "synth"
    synthetic_tree(root)
    t0 = time.perf_counter()
    censuses.append(("train_vae", vae_phase(root / "data", tmp / "vae" / "vae.pt", device,
                                            kernels, card)))
    log(f"phase 9b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    censuses.append(("synth_scratch", synth_phase(root, tmp / "vae" / "vae.pt", tmp, device,
                                                  kernels, checked, card)))
    log(f"phase 9c, e: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    for label, cfg in other_configs().items():
        t0 = time.perf_counter()
        expected = train_expected_launches(train_shapes(cfg, TRAIN_BATCH))
        _, _, _, census = train_phase(
            cfg, device, kernels, expected, steps=CONFIG_STEPS, warmup=1,
            label=f"phase 9d {label}", check="fp32" if label == "fine" else None,
            leaves=FINE_LEAVES if label == "fine" else NAMED_LEAVES, profile=False)
        censuses.append((f"{label} training", census))
        torch.cuda.empty_cache()
        log(f"phase 9d {label}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 9 training complete: {time.perf_counter() - t_phase:.1f} s")
    return censuses


# phase 10: the eval harness (the JAX package's docs/eval.md stages 1 - 4 on
# the port's apps) on the port's synthetic tree: 2 subjects x 2 expressions x
# 20 views at 256^2 with the landmarks painted. eval_generate's 20 targets
# make 2 view groups, so each sampler call runs at B = 2 (K1 at 32 views a
# call, K2 at 64 on the CFG-doubled batch)
EVAL_SUBJECTS, EVAL_EXPRESSIONS, EVAL_VIEWS, EVAL_SIZE = 2, 2, 20, 256
EVAL_LIMIT = 2  # eval_generate's (subject, expression) pairs: one sampler call each
LANDMARK_STEPS, LANDMARK_BATCH = 200, 16
LANDMARK_NORMS = 14  # LandmarkNet's GroupNorms a forward, each one K4 launch
# a network's card output against its CPU output on the same weights and
# images, TF32 off: relative L2 (LPIPS, IR-SE50, CLIP) and pixels (landmarks)
REL_L2_CARD_CPU, LANDMARK_CARD_CPU_PX = 1e-4, 0.05


def run_main(main_fn, argv):
    """run_cli for a CLI whose main returns its result: (result, stdout,
    seconds)."""
    box = {}
    text, seconds = run_cli(lambda a: box.update(result=main_fn(a)), argv)
    return box["result"], text, seconds


def eval_inputs(root: Path, device):
    """Phase 10 (a): the synthetic tree with its landmark ids, a
    reference-named fp16 checkpoint of Config()'s seeded weights (the coarse
    model: no xyzc_net), facescape.yaml pointed at the tree's meshes, seeded
    VGG16 and lpips-lin files in the published namings, and a seeded IR-SE50
    in the reference Backbone's names. Returns the paths by name."""
    import yaml

    from morphablediffusion_torch.eval import irse, lpips_vgg
    from morphablediffusion_torch.tools import make_synthetic_facescape, make_synthetic_landmarks
    from morphablediffusion_torch.utils import torch_import as ti
    from morphablediffusion_torch.utils.config import Config

    f = {name: root / name for name in ("landmarks.json", "facescape_eval.yaml", "model.ckpt",
                                        "vgg16.pth", "vgg_lin.pth", "ir_se50.pth")}
    f["data"] = root / "data"
    t0 = time.perf_counter()
    run_cli(make_synthetic_landmarks.main, ["--out", str(f["landmarks.json"])])
    run_cli(make_synthetic_facescape.main, [
        "--out", str(root), "--subjects", str(EVAL_SUBJECTS), "--expressions",
        str(EVAL_EXPRESSIONS), "--views", str(EVAL_VIEWS), "--image_size", str(EVAL_SIZE),
        "--mark_landmarks", str(f["landmarks.json"])])
    t1 = time.perf_counter()
    model = serving_model(Config(), device, seed=0, cast=False)
    n = ti.export_torch_checkpoint(model, f["model.ckpt"], dtype=torch.float16)
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    raw = yaml.safe_load(Path(CLI_CONFIG).read_text())
    raw["data"]["flame_assets_dir"] = str(root / "flame")
    f["facescape_eval.yaml"].write_text(yaml.safe_dump(raw))
    g = torch.Generator().manual_seed(5)
    vgg, cin = {}, 3
    for idx, width in lpips_vgg.VGG_CONVS:
        vgg[f"features.{idx}.weight"] = torch.randn(width, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
        vgg[f"features.{idx}.bias"] = torch.randn(width, generator=g) * 0.02
        cin = width
    widths = dict(lpips_vgg.VGG_CONVS)
    torch.save(vgg, f["vgg16.pth"])
    torch.save({f"lin{s}.model.1.weight": torch.rand(1, widths[i], 1, 1, generator=g) * 0.1
                for s, i in enumerate(lpips_vgg.STAGE_ENDS)}, f["vgg_lin.pth"])
    torch.save(irse.seeded_irse50(2).state_dict(), f["ir_se50.pth"])
    pngs = len(list(f["data"].rglob("*.png")))
    log(f"phase 10 (a) inputs: {pngs} views of {EVAL_SIZE}^2 ({t1 - t0:.1f} s); Config()'s "
        f"seeded weights as a reference-named fp16 checkpoint, {n} tensors, "
        f"{f['model.ckpt'].stat().st_size / 2**30:.2f} GiB ({t2 - t1:.1f} s); seeded VGG16, "
        f"lpips lins and IR-SE50 in the published namings")
    if pngs != EVAL_SUBJECTS * EVAL_EXPRESSIONS * EVAL_VIEWS:
        raise AssertionError(f"phase 10 (a): {pngs} pngs written")
    return f


def eval_generate_phase(f, out: Path, device, kernels, checked):
    """Phase 10 (b): eval_select_views, then eval_generate --mode nes
    --limit 2 through main([...]) at full width: phase 2 at a sampler call's
    shapes first, then per sampler call (wrapped) its batch, launches (K1 350
    + 150 + 0, K2 250, K4 the call's GroupNorm census), CUDA-event seconds
    and peak memory; the strips finite, not constant, one tile a target.
    Returns (the stage-1 JSON, the strips' directory, a call's GroupNorm
    census, the calls)."""
    from PIL import Image

    from morphablediffusion_torch.apps import eval_generate, eval_select_views
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import group_norm as gn
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils.config import load_config

    views = out / "views.json"
    _, s1 = run_cli(eval_select_views.main, ["--data_dir", str(f["data"]), "--output",
                                            str(views), "--subjects", "001", "002"])
    meta = json.loads(views.read_text())
    targets = {len(meta[s][e]["target_views"]) for s in meta for e in meta[s] if meta[s][e]}
    cfg = load_config(f["facescape_eval.yaml"])
    groups = math.ceil(EVAL_VIEWS / cfg.model.view_num)
    log(f"phase 10 (b) eval_select_views: {sum(len(meta[s]) for s in meta)} (subject, "
        f"expression) entries, targets per entry {targets} ({s1:.2f} s)")
    if targets != {EVAL_VIEWS}:
        raise AssertionError(f"phase 10 (b): targets per entry {targets}")

    # phase 2 at one sampler call's shapes: B = groups samples of view_num views
    B = groups * cfg.model.view_num
    k1s = [{k: v for k, v in s.items() if k != "fused"}
           for s in depth_blocks(cfg, B, train=False) if s["fused"]]
    k2s = dict(main_path_shapes(cfg)[1], B=2 * B)
    g = torch.Generator(device).manual_seed(10)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    with torch.inference_mode():
        for name, rows in check_k1(k1s, device, rn, 10, "eval_generate").items():
            checked[name] = checked.get(name, []) + rows
        checked["flash_attention"].append(check_k2(k2s, device, rn, 10, "eval_generate"))

    calls, sample = [], SyncDDIMSampler.sample

    def counted_sample(self, batch, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k.name: k.launches for k in kernels}
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        res = []
        ev0.record()
        census = gn_census(lambda: res.append(sample(self, batch, *args, **kwargs)))
        ev1.record()
        torch.cuda.synchronize()
        calls.append(dict(B=int(batch["input_image"].shape[0]), census=census,
                          steps=self.ddim.num_steps,
                          seconds=ev0.elapsed_time(ev1) / 1e3,
                          peak=torch.cuda.max_memory_allocated(),
                          launches={k.name: k.launches - before[k.name] for k in kernels}))
        return res[0]

    gen_dir = out / "generated"
    SyncDDIMSampler.sample = counted_sample
    try:
        _, s2 = run_cli(eval_generate.main, [
            "--data_dir", str(f["data"]), "--mode", "nes", "--cfg", str(f["facescape_eval.yaml"]),
            "--ckpt", str(f["model.ckpt"]), "--output_dir", str(gen_dir), "--views_json",
            str(views), "--nes_exp", "02", "--limit", str(EVAL_LIMIT)])
    finally:
        SyncDDIMSampler.sample = sample
    if len(calls) != EVAL_LIMIT:
        raise AssertionError(f"phase 10 (b): {len(calls)} sampler calls")
    for i, c in enumerate(calls):
        cfg.model.sample_steps = c["steps"]  # eval_generate's --sample_steps
        want = avatar_launches(kernels, cfg, k1s, k2s, c["census"])
        log(f"phase 10 (b) eval_generate sampler call {i}: B={c['B']} ({c['B']} x "
            f"{cfg.model.view_num} views, {c['steps']} steps) {c['seconds']:.3f} s "
            f"(CUDA events), peak allocated {c['peak'] / 2**30:.2f} GiB; launches "
            f"{c['launches']} (expected {want})")
        if c["B"] != groups or c["launches"] != want:
            raise AssertionError(f"phase 10 (b): call {i} at B={c['B']}, launches "
                                 f"{c['launches']}, expected {want}")
    k1 = tuple(want[k.name] for k in (da.WGMMA_KERNEL, da.CLUSTER_KERNEL, da.KERNEL))
    if k1 != (350, 150, 0) or want["flash_attention"] != 250:
        raise AssertionError(f"phase 10 (b): K1 {k1}, K2 {want['flash_attention']} a call")
    strips = sorted(gen_dir.glob("*.png"))
    shapes = [np.asarray(Image.open(p)).shape for p in strips]
    spreads = [float(np.asarray(Image.open(p), np.float32).std()) for p in strips]
    log(f"  eval_generate: {s2:.1f} s host clock for the whole CLI call (model build, "
        f"{f['model.ckpt'].stat().st_size / 2**30:.2f} GiB import, {len(calls)} sampler calls, "
        f"writes); strips {[p.name for p in strips]} {shapes} std {spreads}; K4 "
        f"{calls[0]['launches'][gn.KERNEL.name]} launches a call")
    if (len(strips) != EVAL_LIMIT or any(s != (EVAL_SIZE, EVAL_VIEWS * EVAL_SIZE, 3)
                                         for s in shapes) or not min(spreads) > 0):
        raise AssertionError(f"phase 10 (b): strips {shapes}, std {spreads}")
    return views, gen_dir, calls[0]["census"], calls


def landmark_phase(f, out: Path, kernels):
    """Phase 10 (c): train_keypoints on the mesh labels at 256^2, batch 16,
    LANDMARK_STEPS steps: the loss finite and falling, K4 14 launches a step
    (the forward; its backward recomputes the plain version) and no other
    hand kernel. Returns (the weights, a step's GroupNorm census)."""
    from morphablediffusion_torch.apps import train_keypoints
    from morphablediffusion_torch.ops import group_norm as gn

    net = out / "landmark_net.pt"
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    box = {}
    census = gn_census(lambda: box.update(run=run_main(train_keypoints.main, [
        "--image_dir", str(f["data"]), "--labels", f"mesh:{f['landmarks.json']}",
        "--mesh", str(f["data"].parent / "flame" / "{subject}" / "{exp}" / "mesh.obj"),
        "--out", str(net), "--steps", str(LANDMARK_STEPS), "--batch", str(LANDMARK_BATCH),
        "--image_size", str(EVAL_SIZE)])))
    losses, _, seconds = box["run"]
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    want[gn.KERNEL.name] = LANDMARK_NORMS * LANDMARK_STEPS
    w = max(1, LANDMARK_STEPS // 10)  # the first and the last tenth of the steps
    head, tail = np.mean(losses[:w]), np.mean(losses[-w:])
    log(f"phase 10 (c) train_keypoints: {LANDMARK_STEPS} steps of B={LANDMARK_BATCH} at "
        f"{EVAL_SIZE}^2 in {seconds:.1f} s ({seconds / LANDMARK_STEPS * 1e3:.1f} ms a step, host "
        f"clock, data included); loss {losses[0]:.5f} -> {losses[-1]:.5f} (mean of the first "
        f"{w} {head:.5f}, of the last {w} {tail:.5f}); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} (expected "
        f"{want}); {sum(census.values())} GroupNorm calls over {len(census)} shapes")
    if (len(losses) != LANDMARK_STEPS or not all(math.isfinite(v) for v in losses)
            or not tail < head):
        raise AssertionError(f"phase 10 (c): losses not finite and falling: {head}, {tail}")
    if launches != want or sum(census.values()) != want[gn.KERNEL.name]:
        raise AssertionError(f"phase 10 (c): launches {launches}, expected {want}")
    return net, {k: n // LANDMARK_STEPS for k, n in census.items()}


def counted_cli(label, main_fn, argv, kernels):
    """A CLI call with every launch counter at 0 before it and its GroupNorm
    census: only K4 may launch, once per GroupNorm call. Returns (main's
    result, census, seconds)."""
    from morphablediffusion_torch.ops import group_norm as gn

    for k in kernels:
        k.launches = 0
    box = {}
    census = gn_census(lambda: box.update(run=run_main(main_fn, argv)))
    result, _, seconds = box["run"]
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    want[gn.KERNEL.name] = sum(census.values())
    log(f"{label}: {seconds:.2f} s; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return result, census, seconds


def exact_strips(f, gen_dir: Path, views: Path, out: Path):
    """Strips of the ground truth as eval_2d loads it (`_load_gt`, rounded
    to uint8), for the (subject, expression) pairs of gen_dir."""
    from PIL import Image

    from morphablediffusion_torch.apps.eval_2d import _load_gt

    meta = json.loads(views.read_text())
    out.mkdir()
    for p in sorted(gen_dir.glob("*.png")):
        s, e = p.stem.split("_")
        tiles = [_load_gt(f["data"] / s / e / f"view_{int(v):05d}", EVAL_SIZE)[0]
                 for v in meta[s][e]["target_views"]]
        Image.fromarray(np.round(np.concatenate(tiles, axis=1) * 255).astype(np.uint8)).save(
            out / p.name)
    return out


def card_vs_cpu(f, net: Path, gen_dir: Path, device):
    """Phase 10 (g): each network on the card against the port's CPU run on
    the same weights and images, TF32 off (set at start)."""
    from PIL import Image

    from morphablediffusion_torch.apps.eval_2d import _load_clip_encoder, _load_gt, _load_strip
    from morphablediffusion_torch.eval import irse, keypoint_net, lpips_vgg
    from morphablediffusion_torch.eval.metrics import clip_features

    gt = np.stack([_load_gt(p.parent, EVAL_SIZE)[0]
                   for p in sorted(f["data"].rglob("*.png"))[::10]])  # 8 views
    gen = np.stack(_load_strip(sorted(gen_dir.glob("*.png"))[0], EVAL_SIZE)[:len(gt)])
    errs = {}
    on = lambda fn: {dev: fn(dev) for dev in (device, "cpu")}
    lp = on(lambda dev: lpips_vgg.load_lpips(str(f["vgg16.pth"]), str(f["vgg_lin.pth"]), dev))
    nets = {dev: fn.keywords["net"] for dev, fn in lp.items()}
    if {dev: next(n.parameters()).device.type for dev, n in nets.items()} != {
            device: "cuda", "cpu": "cpu"}:
        raise AssertionError("phase 10 (g): LPIPS did not run on both devices")
    d = {dev: fn(gen[:2], gt[:2]) for dev, fn in lp.items()}
    errs["lpips"] = rel_l2(torch.from_numpy(d[device]), torch.from_numpy(d["cpu"]))
    with torch.no_grad():  # the VGG stages the distances average over
        x = torch.from_numpy(gen[:2]).permute(0, 3, 1, 2)
        stages = {dev: [y.cpu() for y in n.stages((x.to(dev) * 2 - 1 - n.shift) / n.scale)]
                  for dev, n in nets.items()}
    log(f"phase 10 (g) LPIPS distances: card {[float(v) for v in d[device]]}, CPU "
        f"{[float(v) for v in d['cpu']]}; the five VGG stages, card against CPU, relative "
        f"L2 {', '.join(f'{rel_l2(a, b):.2e}' for a, b in zip(stages[device], stages['cpu']))}")
    del lp, nets, stages
    d = on(lambda dev: irse.face_descriptors(gt, irse.load_irse50(f["ir_se50.pth"], dev)))
    errs["ir_se50"] = rel_l2(torch.from_numpy(d[device]), torch.from_numpy(d["cpu"]))
    enc = _load_clip_encoder(str(f["model.ckpt"]), str(f["facescape_eval.yaml"]), "cpu")
    cpu = clip_features(gt[:4], enc)
    errs["clip"] = rel_l2(torch.from_numpy(clip_features(gt[:4], enc.to(device))),
                          torch.from_numpy(cpu))
    del enc
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                     for p in sorted(f["data"].rglob("*.png"))[::10]])
    d = on(lambda dev: keypoint_net.detect(keypoint_net.load_params(net, dev), imgs))
    px = float(np.abs(d[device] - d["cpu"]).max())
    log(f"phase 10 (g) card vs CPU, TF32 off: relative L2 LPIPS {errs['lpips']:.2e} (2 pairs), "
        f"IR-SE50 {errs['ir_se50']:.2e} (8 views), CLIP {errs['clip']:.2e} (4 views; ViT-L/14 "
        f"at Config()'s width); landmark coordinates largest difference {px:.2e} px (8 views)")
    if not (max(errs.values()) <= REL_L2_CARD_CPU and px <= LANDMARK_CARD_CPU_PX):
        raise AssertionError(f"phase 10 (g): {errs}, landmarks {px} px")
    return errs, px


def check_metrics(label, result, perfect: bool):
    """Every metric present, finite and in its range (SSIM within rounding
    of [-1, 1]; PSNR may be infinite on the perfect strips); on those, JAX's
    perfect-case bounds."""
    keys = ("ssim", "psnr", "lpips", "fid", "pck@0.2", "re_id")
    vals = {k: result.get(k) for k in keys}
    ok = (all(isinstance(v, float) and (math.isfinite(v) or (perfect and k == "psnr"))
              for k, v in vals.items())
          and vals["psnr"] > (40 if perfect else 0)
          and "unavailable_backends" not in result and abs(vals["ssim"]) <= 1 + 1e-9
          and vals["lpips"] >= 0 and vals["fid"] >= -1e-3 and 0 <= vals["pck@0.2"] <= 1
          and 0 <= vals["re_id"] <= 1)
    if perfect:
        ok = ok and (vals["ssim"] > 0.99 and vals["fid"] < 1e-3 and vals["lpips"] < 1e-6
                     and vals["re_id"] == 1.0 and vals["pck@0.2"] == 1.0)
    log(f"{label} metrics: {json.dumps(result)}")
    if not ok:
        raise AssertionError(f"{label}: metrics {result}")


def eval_phase(device, kernels, checked, keep: Path):
    """Phase 10: the eval harness ((a) - (h) in the module docstring).
    Copies the landmark net of (c) and two painted views (subject 001,
    expressions 01 and 02, view 0) into `keep` for phase 11, and moves the
    tree and its stage-1 views there for phase 13 (e). Returns the
    GroupNorm censuses for K4's check."""
    from morphablediffusion_torch.apps import calibrate_reid, eval_2d, eval_keypoints

    t_phase, seconds, censuses = time.perf_counter(), {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        f = eval_inputs(tmp, device)
        seconds["(a) inputs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        views, gen_dir, census, calls = eval_generate_phase(f, tmp, device, kernels, checked)
        censuses.append(("eval_generate", census))
        seconds["(b) select, phase 2, generate"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        net, census = landmark_phase(f, tmp, kernels)
        censuses.append(("train_keypoints step", census))
        seconds["(c) train_keypoints"] = time.perf_counter() - t0

        kp = {}
        for name, image_dir, extra in (("gt", f["data"], []), ("gen", gen_dir, ["--strips"])):
            _, census, seconds[f"(d) eval_keypoints {name}"] = counted_cli(
                f"phase 10 (d) eval_keypoints --backend native on the {name} views",
                eval_keypoints.main, ["--image_dir", str(image_dir), "--output",
                                      str(tmp / f"kpts_{name}.json"), "--weights", str(net),
                                      "--views_json", str(views), "--image_size",
                                      str(EVAL_SIZE), *extra], kernels)
            censuses.append((f"eval_keypoints {name}", census))
            kp[name] = json.loads((tmp / f"kpts_{name}.json").read_text())
        log(f"  keypoints: {len(kp['gt'])} GT views, {len(kp['gen'])} strip tiles, generated "
            f"keys all among the GT's: {set(kp['gen']) <= set(kp['gt'])}")
        if (len(kp["gt"]) != EVAL_SUBJECTS * EVAL_EXPRESSIONS * EVAL_VIEWS
                or len(kp["gen"]) != EVAL_LIMIT * EVAL_VIEWS or not set(kp["gen"]) <= set(kp["gt"])):
            raise AssertionError("phase 10 (d): keypoint files")

        cal = {}
        for embedder, weights in (("irse", ["--reid_weights", str(f["ir_se50.pth"])]),
                                  ("landmark", ["--weights", str(net)])):
            cal[embedder], census, seconds[f"(e) calibrate_reid {embedder}"] = counted_cli(
                f"phase 10 (e) calibrate_reid --embedder {embedder}", calibrate_reid.main,
                ["--data_dir", str(f["data"]), "--embedder", embedder, "--pairing", "same_view",
                 "--out", str(tmp / f"cal_{embedder}.json"), *weights], kernels)
            if census:
                censuses.append((f"calibrate_reid {embedder}", census))
        log("  calibration: " + "; ".join(
            f"{e} same {r['same']['mean']:.4f} +- {r['same']['std']:.4f}, diff "
            f"{r['diff']['mean']:.4f} +- {r['diff']['std']:.4f}, EER threshold "
            f"{r['eer_threshold']:.4f} (EER {r['eer']:.3f}, d' {r['d_prime']:.2f})"
            for e, r in cal.items()))
        if not all(math.isfinite(r["eer_threshold"]) and r["eer_threshold"] > 0
                   for r in cal.values()):
            raise AssertionError(f"phase 10 (e): {cal}")

        five = ["--data_dir", str(f["data"]), "--views_json", str(views),
                "--image_size", str(EVAL_SIZE),
                "--gt_kpts", str(tmp / "kpts_gt.json"), "--ckpt", str(f["model.ckpt"]),
                "--cfg", str(f["facescape_eval.yaml"]), "--reid_weights", str(f["ir_se50.pth"]),
                "--reid_threshold", repr(cal["irse"]["eer_threshold"]),
                "--lpips_vgg", str(f["vgg16.pth"]), "--lpips_lin", str(f["vgg_lin.pth"])]
        result, _, s = run_main(eval_2d.main, five + [
            "--generated_dir", str(gen_dir), "--pred_kpts", str(tmp / "kpts_gen.json")])
        check_metrics("phase 10 (f) eval_2d, all five", result, perfect=False)
        perfect, _, s_perfect = run_main(eval_2d.main, five + [
            "--generated_dir", str(exact_strips(f, gen_dir, views, tmp / "exact")),
            "--pred_kpts", str(tmp / "kpts_gt.json")])
        check_metrics("phase 10 (f) eval_2d on strips equal to the ground truth", perfect,
                      perfect=True)
        seconds["(f) eval_2d"], seconds["(f) eval_2d perfect"] = s, s_perfect
        t0 = time.perf_counter()
        card_vs_cpu(f, net, gen_dir, device)
        seconds["(g) card vs CPU"] = time.perf_counter() - t0
        shutil.copy(net, keep / "landmark_net.pt")
        for exp, name in (("01", "photo_in.png"), ("02", "photo_exp.png")):
            shutil.copy(f["data"] / "001" / exp / "view_00000" / "rgba_colorcalib.png",
                        keep / name)
        shutil.move(str(f["data"]), str(keep / "eval_data"))  # phase 13 (e)
        shutil.copy(views, keep / "eval_views.json")
    log(f"phase 10 (h) seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; the "
        f"avatar at B=2 {[round(c['seconds'], 3) for c in calls]} s (CUDA events), peak "
        f"{max(c['peak'] for c in calls) / 2**30:.2f} GiB; phase 10 the eval harness: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return censuses


# phase 11: FLAME fitting (apps/fit_face.py) on the card and the rest of the
# host-side preprocessing, on the port's synthetic FLAME assets at FLAME2020's
# published widths (the licensed asset is not on the machine): 5 023
# vertices, 9 976 faces, 300 + 100 blendshape columns (100 + 50 fitted), 5
# joints, 51 static landmarks and the 79 x 17 jaw-contour table
FLAME_VERTICES, FLAME_FACES = 5023, 9976
# The seed's fits land at 0.58 - 0.75 px in both packages on the CPU, also
# with the landmarks moved by 1e-3 px; seeds 11 and 15 reach a 1.2 - 1.7 px
# local minimum in some fits of either package at 40 LM iterations a stage
# (tests/fit_seed_study.py; ROADMAP Queue C)
FIT_SIZE, FIT_NOISE_PX, FIT_SEED = 512, 0.5, 13  # the photos; fit_face's focal 1.2 x 512
FIT_MAX_PX = 1.0  # each photo's mean reprojection error against its noisy landmarks
# (global yaw deg, jaw opening rad, expression on) of the two photos
FIT_PHOTOS = {"input": (8.0, 0.0, False), "exp": (-12.0, 0.15, True)}
# the (b) fit on the card against the same fit on the CPU (TF32 off): on
# noisy landmarks the LM paths part in fp32 along the rigid stages' gauge
# null space (ROADMAP Queue C) and stop at different points of a flat
# valley after 40 iterations, so these bound two fp32 fits, not rounding:
# the PLY's vertices and each photo's flat canonical parameters (relative
# L2) and its mean reprojection error (px). The bounds are about twice the
# spread of CPU fits whose landmarks differ by 1e-3 px; (d) prints that
# spread for one such pair beside the card's distance
FIT_CARD_CPU = {"verts": 0.1, "params": 0.7, "px": 0.3}
# the deterministic part of (d): at the ground truth, the residuals and
# the Jacobian, and the first LM proposal through J (J·delta: its component
# in the gauge null space is rounding), card against CPU, relative L2
LM_STEP_CARD_CPU = {"r": 1e-5, "J": 1e-5, "J·delta": 1e-3}
KPT_TF32_PX = 1.0  # landmark net, card with cuDNN TF32 on (fit_face's default) vs CPU
# the C++ rasterizer against its numpy version at the FLAME mesh, 512^2: pixels
# whose coverage differs (triangle edges), as a share of the covered ones,
# and the depth elsewhere (relative)
RASTER_EDGE_SHARE, RASTER_DEPTH_REL = 1e-3, 1e-5
CALIB_VIEWS, CALIB_SIZE = 16, 256  # (f): FaceScape's crops


@contextlib.contextmanager
def lm_stages(record):
    """Every LM stage that fit_face runs, timed (synchronized before and
    after) with the host syncs inside it counted (`set_sync_debug_mode`
    "warn": a stage must make none)."""
    import warnings

    from morphablediffusion_torch.fitting import fit

    runner = fit._lm_stage_runner

    def timed_runner(res_fn, P):
        run = runner(res_fn, P)

        def timed(flat, mask, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = run(flat, mask, steps)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            sites = [f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}" for w in caught
                     if "synchroniz" in str(w.message)]
            record.append(dict(steps=steps, seconds=time.perf_counter() - t0,
                               syncs=len(sites), sites=sorted(set(sites))))
            return out

        return timed

    fit._lm_stage_runner = timed_runner
    try:
        yield record
    finally:
        fit._lm_stage_runner = runner


@contextlib.contextmanager
def recorded_fits(record):
    """The canonical parameters of every `fit_landmarks` call (fit_face fits
    the input photo, then the expression photo)."""
    from morphablediffusion_torch.fitting import fit

    fit_landmarks = fit.fit_landmarks

    def recorded(*args, **kwargs):
        params, info = fit_landmarks(*args, **kwargs)
        record.append(np.concatenate([np.asarray(params[k]).reshape(-1) for k in fit.KEYS]))
        return params, info

    fit.fit_landmarks = recorded
    try:
        yield record
    finally:
        fit.fit_landmarks = fit_landmarks


def flame_inputs(root: Path, device):
    """Phase 11 (a), (b)'s inputs: the synthetic FLAME assets at FLAME2020's
    widths, loaded on the card; ground-truth codes and poses of two photos
    from a seed, their 68 landmarks projected at 512^2 (focal 1.2 x 512)
    with 0.5 px of noise as .npy, and photos with the ground-truth mesh's
    silhouette (the port's rasterizer) painted as a textured subject on a
    uniform background, for (e)'s matting."""
    from PIL import Image

    from morphablediffusion_torch.fitting import flame, load_model, silhouette
    from morphablediffusion_torch.tools import make_synthetic_flame

    t0 = time.perf_counter()
    run_cli(make_synthetic_flame.main, ["--out", str(root), "--vertices", str(FLAME_VERTICES),
                                        "--faces", str(FLAME_FACES)])
    f = {"flame": root / "generic_model.pkl", "lmk_embedding": root / "landmark_embedding.npy"}
    t1 = time.perf_counter()
    model = load_model(str(f["flame"]), str(f["lmk_embedding"]), device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sizes = {k: tuple(getattr(model, k).shape) for k in (
        "v_template", "faces", "shapedirs", "posedirs", "j_regressor", "lmk_faces",
        "dyn_lmk_faces")}
    log(f"phase 11 (a) synthetic FLAME assets: {sizes}, parents {model.parents}; written in "
        f"{t1 - t0:.2f} s ({f['flame'].stat().st_size / 2**20:.1f} MiB), loaded onto "
        f"{model.device} in {t2 - t1:.2f} s")
    if (sizes["v_template"], sizes["faces"], sizes["shapedirs"], sizes["lmk_faces"],
            sizes["dyn_lmk_faces"]) != ((FLAME_VERTICES, 3), (FLAME_FACES, 3),
                                        (FLAME_VERTICES, 3, 150), (51, 3), (79, 17, 3)):
        raise AssertionError(f"phase 11 (a): sizes {sizes}")

    rng = np.random.default_rng(FIT_SEED)
    S = FIT_SIZE
    K = np.asarray([[1.2 * S, 0, S / 2], [0, 1.2 * S, S / 2], [0, 0, 1]], np.float32)
    shape = rng.normal(size=model.n_shape).astype(np.float32)
    expr = (0.8 * rng.normal(size=model.n_exp)).astype(np.float32)
    gt = {}
    for name, (yaw, jaw, with_exp) in FIT_PHOTOS.items():
        pose = np.zeros(model.num_joints * 3, np.float32)
        pose[1], pose[6] = np.radians(yaw), jaw
        p = {"shape": shape, "exp": expr if with_exp else np.zeros_like(expr), "pose": pose,
             "cam_r": np.asarray([0.02, 0.0, 0.0], np.float32),
             "cam_t": np.asarray([0.01, -0.01, 0.5], np.float32)}
        t = {k: torch.as_tensor(v, device=device) for k, v in p.items()}
        with torch.no_grad():
            lmk = flame.project_points(
                flame.flame_landmarks(model, flame.flame_forward(model, t["shape"], t["exp"],
                                                                 t["pose"]), t["pose"]),
                t["cam_r"], t["cam_t"], torch.as_tensor(K, device=device)).cpu().numpy()
        f[f"{name}_landmarks"] = root / f"lmk_{name}.npy"
        np.save(f[f"{name}_landmarks"], lmk + rng.normal(size=lmk.shape) * FIT_NOISE_PX)
        mask = silhouette.render_silhouette(model, p, K, S)
        yy, xx = np.mgrid[0:S, 0:S]
        img = np.full((S, S, 3), 200, np.uint8)
        img[mask] = np.stack([80 + yy[mask] % 17, 40 + xx[mask] % 11,
                              np.full(int(mask.sum()), 60)], -1)
        f[f"{name}_img"] = root / f"photo_{name}.png"
        Image.fromarray(img).save(f[f"{name}_img"])
        gt[name] = p
        log(f"  {name} photo: yaw {yaw:+.0f} deg, jaw {jaw} rad, expression {with_exp}; "
            f"landmarks x {lmk[:, 0].min():.1f} - {lmk[:, 0].max():.1f}, y "
            f"{lmk[:, 1].min():.1f} - {lmk[:, 1].max():.1f} px; silhouette "
            f"{mask.mean():.3f} of the photo")
    return f, model, K, gt


def fit_argv(f, out: Path, *extra):
    return ["--input_img", str(f["input_img"]), "--exp_img", str(f["exp_img"]),
            "--flame", str(f["flame"]), "--lmk_embedding", str(f["lmk_embedding"]),
            "--out", str(out), *extra]


def fit_report(label, info, stages, seconds, first: bool = False):
    """Log a fit_face call's stage costs, stage seconds, LM iterations per
    second and seconds; fail on a host sync inside a stage. With `first`
    (the process's first LM stage: cuSOLVER and functorch initialize) that
    stage may sync once and is left out of the rate."""
    warm = stages[1:] if first else stages
    rate = sum(s["steps"] for s in warm) / sum(s["seconds"] for s in warm)
    syncs = sum(s["syncs"] for s in warm)
    log(f"{label}: {seconds:.2f} s the CLI call (host clock); {len(stages)} LM stages, "
        f"seconds {[round(s['seconds'], 3) for s in stages]}, {rate:.1f} LM iterations/s"
        f"{' after the first stage' if first else ''}; host syncs inside the stages "
        f"{[s['syncs'] for s in stages]} at {sorted({x for s in stages for x in s['sites']})}; "
        f"{', '.join(f'{k} {v:.5f}' for k, v in info.items())}")
    if syncs or (first and stages[0]["syncs"] > 1):
        raise AssertionError(f"{label}: host syncs inside LM stages "
                             f"{[s['syncs'] for s in stages]}")
    return rate


def read_ply(path, label):
    from morphablediffusion_torch.utils.mesh_io import load_ply

    verts, faces = load_ply(path)
    if verts.shape != (FLAME_VERTICES, 3) or faces.shape != (FLAME_FACES, 3) or not (
            np.isfinite(verts).all()):
        raise AssertionError(f"{label}: PLY {verts.shape} {faces.shape}")
    return verts


def lm_step_card_vs_cpu(model, lmk, K, params):
    """Phase 11 (d), the deterministic part: at `params`, the residuals and
    their Jacobian (`torch.func.jacfwd`) on the card against the CPU, and
    the full stage's first LM proposal, delta = -(J^T J + 1e-2 I)^-1 J^T r
    (cuSOLVER on the card), through J (J·delta in fp64 with the CPU's J).
    Returns the relative distances."""
    from morphablediffusion_torch.fitting import fit

    cfg = fit.FitConfig()
    w = np.ones(len(lmk), np.float32)
    w[:17] = cfg.w_contour
    out, card = {}, str(model.device)
    for dev in (card, "cpu"):
        m = model.to(dev)
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in params.items()}
        flat, unravel = fit.ravel(t)
        args = (m, torch.as_tensor(np.asarray(lmk, np.float32), device=dev),
                torch.as_tensor(np.asarray(K, np.float32), device=dev), cfg,
                torch.as_tensor(w, device=dev))
        res = lambda q: fit._residuals(unravel(q), *args)
        r, J = res(flat), torch.func.jacfwd(res)(flat)
        A = J.T @ J + 1e-2 * torch.eye(len(flat), device=dev)
        delta = -torch.linalg.solve_ex(A, J.T @ r)[0]
        out[dev] = [x.double().cpu() for x in (r, J, delta)]
    J64 = out["cpu"][1]
    return {"r": rel_l2(out[card][0], out["cpu"][0]), "J": rel_l2(out[card][1], J64),
            "J·delta": rel_l2(J64 @ out[card][2], J64 @ out["cpu"][2])}


def fit_landmark_phase(f, model, K, gt, out: Path, device):
    """Phase 11 (b) and (d): fit_face on the precomputed landmarks at the
    default 40 LM iterations a stage, then with --overlay; the same fit on
    the CPU. Returns the (b) seconds and iterations per second."""
    from PIL import Image

    from morphablediffusion_torch.apps import fit_face
    from morphablediffusion_torch.fitting import flame

    lmks = ["--input_landmarks", str(f["input_landmarks"]), "--exp_landmarks",
            str(f["exp_landmarks"])]
    stages, params = [], []
    with lm_stages(stages), recorded_fits(params):
        info, _, seconds = run_main(fit_face.main, fit_argv(f, out / "card.ply", *lmks))
    rate = fit_report("phase 11 (b) fit_face, precomputed landmarks", info, stages, seconds,
                      first=True)
    verts = read_ply(out / "card.ply", "phase 11 (b)")
    t = {k: torch.as_tensor(v, device=device) for k, v in gt["exp"].items()}
    with torch.no_grad():
        want = flame.flame_forward(model, t["shape"], t["exp"], t["pose"] * torch.as_tensor(
            [0.0] * 3 + [1.0] * 12, device=device)).cpu().numpy()
    log(f"  the PLY: {verts.shape[0]} vertices, relative L2 to the ground truth's retargeted "
        f"canonical mesh {np.linalg.norm(verts - want) / np.linalg.norm(want):.4f} (identity "
        f"from 68 landmarks is not fully determined)")
    errs = (info["input_mean_px_err"], info["exp_mean_px_err"])
    if not max(errs) <= FIT_MAX_PX:
        raise AssertionError(f"phase 11 (b): mean reprojection errors {errs} px")

    stages_o = []
    with lm_stages(stages_o):
        info_o, _, seconds_o = run_main(fit_face.main, fit_argv(
            f, out / "overlay.ply", *lmks, "--overlay", str(out / "overlay.png")))
    fit_report("phase 11 (b) fit_face --overlay (the input photo fitted again)", info_o,
               stages_o, seconds_o)
    png = np.asarray(Image.open(out / "overlay.png"))
    green = ((png[..., 1] == 255) & (png[..., 0] == 0)).sum()
    red = ((png[..., 0] == 255) & (png[..., 1] == 0)).sum()
    log(f"  overlay {png.shape}: {green} green and {red} red pixels")
    if png.shape != (FIT_SIZE, FIT_SIZE, 3) or not (green and red) or not (
            info_o["overlay_mean_px_err"] <= FIT_MAX_PX):
        raise AssertionError(f"phase 11 (b): overlay {png.shape}, {green}, {red}, {info_o}")

    cpu_params = []
    with recorded_fits(cpu_params):
        info_c, _, seconds_c = run_main(fit_face.main, fit_argv(f, out / "cpu.ply", *lmks,
                                                               "--device", "cpu"))
    cpu = read_ply(out / "cpu.ply", "phase 11 (d)")
    errs = {"verts": float(np.linalg.norm(verts - cpu) / np.linalg.norm(cpu))}
    for i, name in enumerate(("input", "exp")):
        errs[f"params {name}"] = float(np.linalg.norm(params[i] - cpu_params[i])
                                       / np.linalg.norm(cpu_params[i]))
        errs[f"px {name}"] = abs(info[f"{name}_mean_px_err"] - info_c[f"{name}_mean_px_err"])
    log(f"phase 11 (d) the same fit on the CPU: {seconds_c:.2f} s; card against CPU (TF32 "
        f"off): {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (bounds {FIT_CARD_CPU}); "
        f"CPU costs {', '.join(f'{k} {v:.5f}' for k, v in info_c.items())}")
    if not all(v <= FIT_CARD_CPU[k.split()[0]] for k, v in errs.items()):
        raise AssertionError(f"phase 11 (d): {errs}")
    from morphablediffusion_torch.fitting import fit

    lmk = np.load(f["input_landmarks"])
    p_cpu, i_cpu = fit.fit_landmarks(model.to("cpu"), lmk + np.random.default_rng(0).normal(
        size=lmk.shape) * 1e-3, K)
    spread = {"params": float(np.linalg.norm(np.concatenate([p_cpu[k].reshape(-1) for k in
                                                             fit.KEYS]) - cpu_params[0])
                              / np.linalg.norm(cpu_params[0])),
              "px": abs(i_cpu["mean_px_err"] - info_c["input_mean_px_err"])}
    log(f"  the CPU against itself, the input photo's landmarks moved by 1e-3 px: "
        f"{', '.join(f'{k} {v:.2e}' for k, v in spread.items())}")
    step = lm_step_card_vs_cpu(model, lmk, K, gt["input"])
    log(f"  one LM step at the input photo's ground truth, card against CPU: "
        f"{', '.join(f'{k} {v:.2e}' for k, v in step.items())} (bounds {LM_STEP_CARD_CPU})")
    if not all(v <= LM_STEP_CARD_CPU[k] for k, v in step.items()):
        raise AssertionError(f"phase 11 (d): one LM step {step}")
    return seconds, rate


def kpt_phase(keep: Path, out: Path, kernels):
    """Phase 11 (c): fit_face --kpt_weights with phase 10 (c)'s landmark net
    at its training size on two of phase 10's painted views: K4 once per
    LandmarkNet GroupNorm call, 14 a photo, and no other kernel; the
    detections on the card against the CPU's with cuDNN TF32 off (the
    script's setting) and on (fit_face's default). Returns the census."""
    from PIL import Image

    from morphablediffusion_torch.apps import fit_face
    from morphablediffusion_torch.ops import group_norm as gn

    f = {"input_img": keep / "photo_in.png", "exp_img": keep / "photo_exp.png",
         "flame": keep / "flame" / "generic_model.pkl",
         "lmk_embedding": keep / "flame" / "landmark_embedding.npy"}
    argv = fit_argv(f, out / "kpt.ply", "--kpt_weights", str(keep / "landmark_net.pt"),
                    "--kpt_size", str(EVAL_SIZE))
    info, census, seconds = counted_cli("phase 11 (c) fit_face --kpt_weights", fit_face.main,
                                        argv, kernels)
    want = 2 * LANDMARK_NORMS
    if sum(census.values()) != want or {k[0][0] for k in census} != {1}:
        raise AssertionError(f"phase 11 (c): GroupNorm census {census}, {want} calls expected")
    read_ply(out / "kpt.ply", "phase 11 (c)")
    if not all(math.isfinite(v) for v in info.values()):
        raise AssertionError(f"phase 11 (c): {info}")
    img = np.asarray(Image.open(f["input_img"]).convert("RGB"), np.float32) / 255.0
    detect = lambda dev: fit_face._detect(img, "", str(keep / "landmark_net.pt"), EVAL_SIZE,
                                          torch.device(dev))
    cpu = detect("cpu")
    px = {"TF32 off": float(np.abs(detect("cuda") - cpu).max())}
    torch.backends.cudnn.allow_tf32 = True
    try:
        px["TF32 on"] = float(np.abs(detect("cuda") - cpu).max())
    finally:
        torch.backends.cudnn.allow_tf32 = False
    log(f"  {sum(census.values())} GroupNorm calls over {len(census)} shapes "
        f"({LANDMARK_NORMS} a photo at {EVAL_SIZE}^2); fit {', '.join(f'{k} {v:.3f}' for k, v in info.items())}; "
        f"the input photo's landmarks, card against CPU, largest difference (px): {px}")
    if not (px["TF32 off"] <= LANDMARK_CARD_CPU_PX and px["TF32 on"] <= KPT_TF32_PX):
        raise AssertionError(f"phase 11 (c): landmarks card vs CPU {px}")
    return census


def silhouette_phase(f, model, K, gt, out: Path):
    """Phase 11 (e): the C++ rasterizer against its numpy version at the
    ground-truth mesh, 512^2; then fit_face --silhouette on the painted
    photos (the native matting recovers the rendered silhouette)."""
    from morphablediffusion_torch.apps import fit_face
    from morphablediffusion_torch.fitting import silhouette
    from morphablediffusion_torch.preprocessing import raster

    vpx = silhouette._verts_px(model, gt["input"], K)
    tris = model.faces.cpu().numpy().astype(np.int32)
    t0 = time.perf_counter()
    native = raster.rasterize_depth_px(vpx, tris, FIT_SIZE, FIT_SIZE)
    t1 = time.perf_counter()
    plain = raster.rasterize_depth_numpy(vpx, tris, FIT_SIZE, FIT_SIZE)
    t2 = time.perf_counter()
    edge = (native > 0) != (plain > 0)
    both = (native > 0) & (plain > 0)
    depth = float((np.abs(native[both] - plain[both]) / plain[both]).max())
    share = edge.sum() / max(int((plain > 0).sum()), 1)
    log(f"phase 11 (e) rasterizer at {FLAME_FACES} faces, {FIT_SIZE}^2: native {t1 - t0:.4f} s, "
        f"numpy {t2 - t1:.2f} s (host); {int((plain > 0).sum())} covered pixels, {int(edge.sum())} "
        f"covered by one only (triangle edges, {share:.2e} of them); depth elsewhere within "
        f"{depth:.2e} relative")
    if not (share <= RASTER_EDGE_SHARE and depth <= RASTER_DEPTH_REL):
        raise AssertionError(f"phase 11 (e): rasterizer edges {share}, depth {depth}")
    stages = []
    lmks = ["--input_landmarks", str(f["input_landmarks"]), "--exp_landmarks",
            str(f["exp_landmarks"])]
    with lm_stages(stages):
        info, _, seconds = run_main(fit_face.main, fit_argv(f, out / "sil.ply", *lmks,
                                                           "--silhouette"))
    fit_report("phase 11 (e) fit_face --silhouette", info, stages, seconds)
    read_ply(out / "sil.ply", "phase 11 (e)")
    sil = [info.get(f"{n}_loss_silhouette", math.nan) for n in ("input", "exp")]
    if not all(math.isfinite(v) for v in sil):
        raise AssertionError(f"phase 11 (e): silhouette costs {sil}")


def calib_phase(model, gt, out: Path):
    """Phase 11 (f): the rest of the host-side preprocessing at FaceScape's
    size: a synthetic capture of the ground-truth head (16 views on a ring,
    256^2, a color field on the surface, a color cast per view), its depth
    by `render_depth_cv`, then `calibrate_colors`."""
    from PIL import Image

    from morphablediffusion_torch.fitting import flame
    from morphablediffusion_torch.preprocessing import color_calib, raster

    dev = model.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in gt["input"].items()}
    with torch.no_grad():
        verts = flame.flame_forward(model, t["shape"], t["exp"], t["pose"]).double().cpu().numpy()
    faces = model.faces.cpu().numpy().astype(np.int32)
    S = CALIB_SIZE
    K = np.asarray([[1.2 * S, 0, S / 2], [0, 1.2 * S, S / 2], [0, 0, 1]])
    rng = np.random.default_rng(FIT_SEED)
    cams, seconds = {}, 0.0
    for i, az in enumerate(np.linspace(-np.pi / 2, np.pi / 2, CALIB_VIEWS)):
        eye = np.asarray([0.6 * np.sin(az), 0.05, -0.6 * np.cos(az)])  # the face looks to -z
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        Rt = np.concatenate([R, (-R @ eye)[:, None]], 1)
        t0 = time.perf_counter()
        depth = raster.render_depth_cv(verts, faces, K, Rt, (S, S))
        seconds += time.perf_counter() - t0
        yy, xx = np.mgrid[0:S, 0:S] + 0.5
        cam = np.stack([(xx - K[0, 2]) / K[0, 0], (yy - K[1, 2]) / K[1, 1], np.ones_like(xx)],
                       -1) * depth[..., None]
        world = (cam - Rt[:, 3]) @ R  # back to the head's frame
        rgb = 0.5 + 0.3 * np.sin(world * [40.0, 30.0, 50.0])
        rgb = np.clip(rgb * (1 + 0.06 * rng.normal(size=3)), 0, 1)
        rgba = np.concatenate([rgb, (depth > 0)[..., None]], -1)
        d = out / "scan" / f"view_{i:05d}"
        d.mkdir(parents=True)
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(d / "rgba.png")
        cams[str(i)] = dict(intrinsics=K.tolist(), extrinsics=Rt.tolist(), angles={})
    (out / "scan" / "cameras.json").write_text(json.dumps(cams))
    t0 = time.perf_counter()
    text, _ = run_cli(lambda a: color_calib.calibrate_colors(out / "scan", verts, faces), [])
    calib = time.perf_counter() - t0
    done = len(list((out / "scan").glob("view_*/rgba_colorcalib.png")))
    log(f"phase 11 (f) render_depth_cv: {CALIB_VIEWS} views of {S}^2 in {seconds:.3f} s; "
        f"calibrate_colors {calib:.2f} s (host), {done} views written, "
        f"{text.count('WARNING')} skipped")
    if done != CALIB_VIEWS:
        raise AssertionError(f"phase 11 (f): {done} calibrated views")


def fitting_phase(device, kernels, keep: Path):
    """Phase 11: FLAME fitting on the card ((a) - (e)) and the rest of the
    host-side preprocessing ((f)). `keep` holds phase 10's landmark net and
    two of its painted views. Returns the GroupNorm census of (c)."""
    t_phase, seconds = time.perf_counter(), {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        f, model, K, gt = flame_inputs(keep / "flame", device)
        seconds["(a) inputs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_s, rate = fit_landmark_phase(f, model, K, gt, tmp, device)
        seconds["(b), (d) fits"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        census = kpt_phase(keep, tmp, kernels)
        seconds["(c) kpt"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        silhouette_phase(f, model, K, gt, tmp)
        seconds["(e) silhouette"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        calib_phase(model, gt, tmp)
        seconds["(f) calibration"] = time.perf_counter() - t0
    log(f"phase 11 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; "
        f"fit_face {cli_s:.2f} s a call, {rate:.1f} LM iterations/s; phase 11 FLAME fitting: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return [("fit_face --kpt_weights", census)]


# phase 13: the JAX package's weight files and the repository's quality and
# sizing tools on the port (morphablediffusion_torch/tools/), before K4's
# check so that their GroupNorm shapes are held there
SHIPPED_NET = ROOT / "artifacts/landmark_net_synth.msgpack"
PCK_ARTIFACT = ROOT / "artifacts/pck_heldout.json"
# pck_heldout.json's recipe: 40 subjects x 2 expressions x 16 views at 128^2
# with the landmarks painted; subjects 038 - 040 held out (96 views)
PCK_RECIPE = ("--subjects", "40", "--expressions", "2", "--views", "16", "--image_size", "128")
PCK_HELD_OUT = ("038", "039", "040")
# the card against the artifact: the JAX tool on the CPU reproduces it from
# the recipe (PCK@0.2 0.7194, 3.301 px against 0.7198, 3.3)
PCK_MAX_DIFF, PX_MAX_DIFF = 0.01, 0.1
FLAME_EVAL_TRIALS, FLAME_EVAL_NOISE = 1, ("0", "0.5")
# depth cut for the script's time limit: (e)'s matting samples (the tool's
# 12), (f)'s sampler steps (the script's 50)
MATTING_SAMPLES, SCRATCH_EVAL_STEPS = 6, 4
SCRATCH_EVAL_SCRIPT = ROOT / "morphablediffusion_torch/tools/eval_synth_scratch.sh"


def landmark_net_phase(tmp: Path, tree_job, kernels):
    """(a) the shipped landmark net (the JAX package's flax-msgpack file)
    read without flax, the held-out tree of pck_heldout.json regenerated
    from its recipe by the port's tools (`tree_job`, `tools_jobs`' process
    writing into `tmp`), and eval_landmark_net on the card,
    plain and shifted: K4 once per GroupNorm call and nothing else, the
    plain PCK@0.2 and mean pixel error beside the artifact's. Returns the
    GroupNorm censuses."""
    from morphablediffusion_torch.tools import eval_landmark_net
    from morphablediffusion_torch.utils import flax_msgpack

    t0 = time.perf_counter()
    tree = flax_msgpack.restore(SHIPPED_NET)
    flat = flax_msgpack.flatten(tree["params"]["params"])
    n = sum(v.size for v in flat.values())
    log(f"phase 13 (a) {SHIPPED_NET.name}: {SHIPPED_NET.stat().st_size} bytes, {len(flat)} "
        f"leaves, {n} parameters, num_keypoints {tree['num_keypoints']} "
        f"({time.perf_counter() - t0:.3f} s)")
    if (tree["num_keypoints"], len(flat), n) != (68, 66, 3_422_980):
        raise AssertionError("phase 13 (a): the shipped landmark net")
    marks = tmp / "landmarks.json"
    seconds = tree_job.wait("phase 13 (a) the held-out tree")
    held = tmp / "test_data"
    held.mkdir()
    for s in PCK_HELD_OUT:
        shutil.move(str(tmp / "data" / s), str(held / s))
    log(f"phase 13 (a) the held-out tree from pck_heldout.json's recipe: "
        f"{len(list((tmp / 'data').rglob('*.png')))} training and "
        f"{len(list(held.rglob('*.png')))} held-out views in {seconds:.1f} s (a process of "
        f"its own, from phase 11 on)")
    art = json.loads(PCK_ARTIFACT.read_text())
    results, censuses = {}, []
    for cond, extra in (("plain", []), ("shifted", ["--shifted"])):
        results[cond], census, _ = counted_cli(
            f"phase 13 (a) eval_landmark_net {cond}", eval_landmark_net.main,
            ["--weights", str(SHIPPED_NET), "--image_dir", str(held), "--landmarks", str(marks),
             "--mesh", str(tmp / "flame/{subject}/{exp}/mesh.obj"), "--image_size", "128",
             "--out", str(tmp / f"pck_{cond}.json"), *extra], kernels)
        censuses.append((f"eval_landmark_net {cond}", census))
    p, s = results["plain"], results["shifted"]
    log(f"phase 13 (a) the shipped net on the card, {p['n_views']} views: plain PCK@0.2 "
        f"{p['pck_0.2']}, PCK@0.5 {p['pck_0.5']}, mean {p['mean_px']} px, median "
        f"{p['median_px']} px (pck_heldout.json: {art['pck_0.2']}, {art['pck_0.5']}, "
        f"{art['mean_pixel_error_128px']} px, {art['median_pixel_error_128px']} px); shifted "
        f"PCK@0.2 {s['pck_0.2']}, PCK@0.5 {s['pck_0.5']}, mean {s['mean_px']} px")
    if (p["n_views"] != art["n_views"] or abs(p["pck_0.2"] - art["pck_0.2"]) > PCK_MAX_DIFF
            or abs(p["mean_px"] - art["mean_pixel_error_128px"]) > PX_MAX_DIFF):
        raise AssertionError(f"phase 13 (a): {p} against {art}")
    return censuses


def flame_eval_phase(tmp: Path):
    """(b) eval_flame_fit on the port's synthetic FLAME assets at FLAME2020's
    widths, 4 trials at 0 and 0.5 px of landmark noise and its retarget
    trials, every number finite."""
    from morphablediffusion_torch.tools import eval_flame_fit, make_synthetic_flame

    run_cli(make_synthetic_flame.main, ["--out", str(tmp / "flame"), "--vertices",
                                        str(FLAME_VERTICES), "--faces", str(FLAME_FACES)])
    res, _, seconds = run_main(eval_flame_fit.main, [
        "--assets", str(tmp / "flame"), "--trials", str(FLAME_EVAL_TRIALS),
        "--noise_px", *FLAME_EVAL_NOISE, "--out", str(tmp / "flame_fit_eval.json")])
    keys = ("px_err", "vertex_rms", "vertex_rms_rel", "shape_cos", "exp_cos", "fit_seconds")
    for noise, agg in res["per_noise"].items():
        log(f"phase 13 (b) eval_flame_fit, {noise} px noise, {len(agg['trials'])} trials "
            f"(means): " + ", ".join(f"{k} {agg[k]:.5g}" for k in keys))
    log(f"phase 13 (b) retarget: " + "; ".join(
        ", ".join(f"{k} {v:.5g}" for k, v in r.items()) for r in res["retarget"])
        + f"; {seconds:.1f} s")
    nums = [v for agg in res["per_noise"].values() for r in agg["trials"] for v in r.values()]
    nums += [v for r in res["retarget"] for v in r.values()]
    if len(res["per_noise"]) != len(FLAME_EVAL_NOISE) or not all(map(math.isfinite, nums)):
        raise AssertionError(f"phase 13 (b): {res}")


def int8_phase(tmp: Path):
    """(c) make_flagship_ckpt (its fp32 file) and int8_trajectory on it at
    full width: bf16 against W8A8 over W8A8_STEPS steps of the same noise
    (seed W8A8_SEED), gated by W8A8_MAX_REL_L2 and W8A8_MIN_PSNR."""
    from morphablediffusion_torch.tools import int8_trajectory, make_flagship_ckpt

    ckpt = tmp / "flagship.ckpt"
    info, _, s_ckpt = run_main(make_flagship_ckpt.main, ["--out", str(ckpt)])
    torch.cuda.empty_cache()
    size = ckpt.stat().st_size
    rep, _, s_traj = run_main(int8_trajectory.main, ["--ckpt", str(ckpt), "--seed",
                                                     str(W8A8_SEED), "--sample_steps",
                                                     str(W8A8_STEPS), "--out",
                                                     str(tmp / "int8_trajectory.json")])
    ckpt.unlink()
    torch.cuda.empty_cache()
    final, psnr = rep["final_rel_l2"], rep["final_image_psnr_bf16_vs_w8a8"]
    log(f"phase 13 (c) make_flagship_ckpt: {info['tensors']} tensors, {info['params_m']} M "
        f"parameters, {size / 2**30:.2f} GiB fp32 in {s_ckpt:.1f} s; int8_trajectory on it: "
        f"final latent relative L2 {final:.5f} (gate {W8A8_MAX_REL_L2}), PSNR {psnr:.2f} dB "
        f"(gate {W8A8_MIN_PSNR}), max abs {rep['final_image_max_abs']:.4f}; {s_traj:.1f} s")
    if not (final <= W8A8_MAX_REL_L2 and psnr >= W8A8_MIN_PSNR):
        raise AssertionError(f"phase 13 (c): W8A8 drift {final:.5f} or PSNR {psnr:.2f} dB")


def memory_phase():
    """(d) memory_report at batch 8 and 16 views: the peaks of one train
    step and one sampling step on the card, and the state's bytes by group
    (AdamW's moments twice the trainable fp32 parameters)."""
    from morphablediffusion_torch.tools import memory_report

    rep, _, seconds = run_main(memory_report.main, ["--batch", str(TRAIN_BATCH), "--views", "16"])
    tr, sa = rep["train"], rep["sample"]
    gib = lambda n: f"{n / 2**30:.2f} GiB"
    log(f"phase 13 (d) memory_report: train step (B={tr['batch']}, 16 views, remat "
        f"{tr['remat']}) peak {gib(tr['peak_bytes'])}, parameters "
        f"{ {k: gib(v) for k, v in tr['parameters'].items()} }, gradients "
        f"{ {k: gib(v) for k, v in tr['gradients'].items()} }, AdamW moments "
        f"{ {k: gib(v) for k, v in tr['adamw_moments'].items()} }; sampling step peak "
        f"{gib(sa['peak_bytes'])} ({gib(sa['parameter_bytes'])} of parameters); {seconds:.1f} s")
    trainable = sum(v for k, v in tr["parameters"].items() if k != "frozen")
    if (sum(tr["adamw_moments"].values()) != 2 * trainable or not tr["peak_bytes"] > 0
            or not sa["peak_bytes"] > 0):
        raise AssertionError(f"phase 13 (d): {rep}")
    torch.cuda.empty_cache()


def matting_anchor_phase(keep: Path, tmp: Path):
    """(e) eval_matting and eval_anchors on phase 10's tree (256^2) and its
    stage-1 views, beside the JAX package's artifacts."""
    from morphablediffusion_torch.tools import eval_anchors, eval_matting

    data = keep / "eval_data"
    mat, _, s_mat = run_main(eval_matting.main, ["--data_dir", str(data), "--samples",
                                                 str(MATTING_SAMPLES), "--out",
                                                 str(tmp / "matting_eval.json")])
    art = json.loads((ROOT / "artifacts/matting_eval.json").read_text())["summary"]
    log("phase 13 (e) eval_matting: " + "; ".join(
        f"{bg} IoU {s['iou_mean']:.3f} (min {s['iou_min']:.3f}) MAE {s['mae_mean']:.3f} over "
        f"{s['n']} (JAX artifact {art[bg]['iou_mean']:.3f}, {art[bg]['mae_mean']:.3f})"
        for bg, s in mat["summary"].items()) + f"; {s_mat:.1f} s")
    # eval_select_views lists every expression 01 - 20 of a subject, an empty
    # entry where the tree has none; the anchors (as the JAX tool) take
    # entries that name their views
    meta = json.loads((keep / "eval_views.json").read_text())
    views = tmp / "anchor_views.json"
    views.write_text(json.dumps({s: {e: m for e, m in d.items() if m}
                                 for s, d in meta.items()}))
    anc, _, s_anc = run_main(eval_anchors.main, [
        "--data_dir", str(data), "--views_json", str(views),
        "--image_size", str(EVAL_SIZE), "--out", str(tmp / "anchors.json")])
    log(f"phase 13 (e) eval_anchors: {anc['pairs_scored']} of {anc['pairs_total']} pairs; "
        f"copy-input SSIM {anc['copy_input']['ssim']:.4f} PSNR {anc['copy_input']['psnr']:.2f}; "
        f"noise SSIM {anc['noise']['ssim']:.4f} PSNR {anc['noise']['psnr']:.2f}; {s_anc:.1f} s")
    ious = [r["iou"] for rows in mat["per_image"].values() for r in rows]
    if (set(mat["summary"]) != {"uniform", "gradient", "clutter"}
            or not all(0 <= v <= 1 for v in ious) or not anc["pairs_scored"] > 0
            or not all(math.isfinite(anc[k][m]) for k in ("copy_input", "noise")
                       for m in ("ssim", "psnr"))):
        raise AssertionError(f"phase 13 (e): {mat['summary']}, {anc}")


class Job:
    """A command run in a process group of its own while the script goes on
    (`wait` ends it, its exit code checked; `stop` kills it if it still
    runs). Its output goes to `log_path`."""

    def __init__(self, label: str, cmd, log_path: Path, env=None):
        self.label, self.log_path = label, log_path
        self.t0 = time.perf_counter()
        self._out = open(log_path, "w")
        self.proc = subprocess.Popen(cmd, env=env, stdout=self._out, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def wait(self, what: str) -> float:
        """Wait for the command (at most PAR_TIMEOUT s); returns its seconds."""
        try:
            rc = self.proc.wait(timeout=PAR_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{what}: {self.label} hung") from None
        seconds = time.perf_counter() - self.t0
        self._out.close()
        if rc:
            log(self.log_path.read_text()[-4000:])
            raise AssertionError(f"{what}: {self.label} exited {rc}")
        return seconds

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
        self._out.close()


def tools_jobs(keep: Path):
    """Phase 13's two slow parts that need neither the card's timings nor
    this process, started after phase 10 (whose kernel timings they would
    disturb) so that they run beside phase 11: (a)'s held-out tree
    (`make_synthetic_landmarks`, then `make_synthetic_facescape` on
    pck_heldout.json's recipe, into keep/kp) and (f)'s eval_synth_scratch.sh
    on phase 9's run. Returns the two Jobs."""
    kp = keep / "kp"
    kp.mkdir()
    tools = "morphablediffusion_torch.tools"
    tree = Job("the held-out tree", ["bash", "-c", " ".join(shlex.quote(a) for a in (
        sys.executable, "-m", f"{tools}.make_synthetic_landmarks", "--out",
        str(kp / "landmarks.json"))) + " && " + " ".join(shlex.quote(a) for a in (
        sys.executable, "-m", f"{tools}.make_synthetic_facescape", "--out", str(kp),
        *PCK_RECIPE, "--mark_landmarks", str(kp / "landmarks.json")))],
        keep / "kp.log", env=dict(os.environ, PYTHONPATH=str(ROOT)))
    run9 = keep / "phase9"
    env = dict(os.environ, CKPT=str(run9 / "runs" / "synth" / "ckpt"),
               CFG=str(run9 / "synth_scratch.yaml"), SUBJECTS=f"{SYNTH_SUBJECTS:03d}",
               STEPS=str(SCRATCH_EVAL_STEPS), IMAGE_SIZE=str(SYNTH_SIZE), PYTHON=sys.executable)
    scratch = Job("eval_synth_scratch.sh",
                  ["bash", str(SCRATCH_EVAL_SCRIPT), str(run9 / "synth"), str(run9 / "eval")],
                  keep / "scratch_eval.log", env)
    return tree, scratch


def scratch_eval_phase(keep: Path, job: Job):
    """(f) the port's eval_synth_scratch.sh on phase 9's run (`job`, started
    by `tools_jobs`): stages 1 - 4 (views of the held-out subject,
    eval_generate nvs and nes, eval_keypoints with the shipped net,
    eval_2d's metrics), each CLI a process on the card; eval_2d's metrics of
    both modes finite."""
    out = keep / "phase9" / "eval"
    seconds = job.wait("phase 13 (f)")
    metrics = {m: json.loads((out / f"metrics_{m}.json").read_text().strip().splitlines()[-1])
               for m in ("nvs", "nes")}
    log(f"phase 13 (f) eval_synth_scratch.sh on phase 9's run ({SCRATCH_EVAL_STEPS} sampler "
        f"steps): {seconds:.1f} s (beside phases 11 and 13); " + "; ".join(
            f"{m} " + ", ".join(f"{k} {v}" for k, v in res.items() if not isinstance(v, dict))
            for m, res in metrics.items()))
    for m, res in metrics.items():
        for k in ("ssim", "psnr", "fid", "pck@0.2"):
            v = res.get(k)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                raise AssertionError(f"phase 13 (f): {m} {k} = {v!r} in {res}")


def tools_phase(device, kernels, keep: Path, jobs):
    """Phase 13 ((a) - (f) in the module docstring), one part at a time.
    Returns the GroupNorm censuses for K4's check."""
    t_phase, seconds, censuses = time.perf_counter(), {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tmp = Path(tmp)
        tree_job, scratch_job = jobs
        parts = (("(a) landmark net", lambda: landmark_net_phase(keep / "kp", tree_job,
                                                                 kernels)),
                 ("(b) eval_flame_fit", lambda: flame_eval_phase(tmp)),
                 ("(c) int8_trajectory", lambda: int8_phase(tmp)),
                 ("(d) memory_report", memory_phase),
                 ("(e) matting, anchors", lambda: matting_anchor_phase(keep, tmp)),
                 ("(f) eval_synth_scratch.sh", lambda: scratch_eval_phase(keep, scratch_job)))
        for label, part in parts:
            t0 = time.perf_counter()
            censuses += part() or []
            seconds[label] = time.perf_counter() - t0
    log(f"phase 13 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; phase 13 "
        f"the weight files and the tools: {time.perf_counter() - t_phase:.1f} s")
    return censuses


# phase 12: more than one rank. On a machine with one card the ranks of (b)
# and (c) share it under gloo (collectives staged through the
# host); (d) runs the NCCL collectives on a one-rank group, and NCCL across
# cards only where there are two.
PAR_WORLDS = (2, 4)  # the per-rank shapes of (a)
PAR_RANKS = 2  # the ranks of (b) and (c)
PAR_TIMEOUT = 600.0  # seconds a spawned rank or torchrun may take
# (b) the W=2 avatar's final latent against the one-process avatar's
# (relative L2), and the W=2 CLI strip's PSNR against the one-process
# strip: the W8A8 drift gates (phase 13 (c)), stated before the first run
PAR_LATENT_MAX_REL_L2, PAR_MIN_PSNR = 0.0505, 37.0
NCCL_MAX_REL_L2 = 1e-6  # (d) the one-rank NCCL group against world 1
PAR_TRAIN_SEEDS = (11, 12)  # (c) the draws of the two steps (phase 6's first)


def all_kernels():
    """Every kernel's CudaKernel (phase 1 builds them; the launch counts)."""
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa
    from morphablediffusion_torch.ops import group_norm as gn

    return (da.WGMMA_KERNEL, da.CLUSTER_KERNEL, da.KERNEL, fa.KERNEL, fa.BWD_DKV_KERNEL,
            fa.BWD_DQ_KERNEL, da.DEPTH_KERNEL, *gn.KERNELS)


def per_rank_shapes(cfg, world: int):
    """The serving shapes of K1 and K2 on one of `world` ranks: its
    N / world views (K1's B), doubled for CFG (K2's B)."""
    k1, k2 = main_path_shapes(cfg)
    return [dict(s, B=s["B"] // world) for s in k1], dict(k2, B=k2["B"] // world)


def digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def rank_sampling(mesh):
    """(b) on one rank: one CFG step (with every spatial volume the rank
    builds digested), the rank's GroupNorm census, and one timed 50-step
    avatar with the launch counts set to 0 just before it; the counts must
    be K1 350 + 150, K2 250 and K4 the census. Returns the results."""
    from morphablediffusion_torch.parallel import collectives
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils.config import Config

    cfg, device, kernels = Config(), mesh.device, all_kernels()
    model = serving_model(cfg, device, seed=0)
    batch = flagship_batch(cfg, device, seed=0)
    volumes = []
    build = model.spatial_volume.construct_spatial_volume

    def record(*a, **k):
        v = build(*a, **k)
        volumes.append(digest(v))
        return v

    model.spatial_volume.construct_spatial_volume = record
    with torch.inference_mode():
        prep = model.prepare_inference(batch)
        eps = one_step(model, batch, prep=prep, mesh=mesh)
    census, _ = avatar_census(model, batch, mesh)
    k1, k2 = per_rank_shapes(cfg, mesh.world)
    want = avatar_launches(kernels, cfg, k1, k2, census)
    sampler = SyncDDIMSampler(model, sample_steps=cfg.model.sample_steps, mesh=mesh)
    gen = torch.Generator(device).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
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
    stats = dict(collectives.STATS)
    if launches != want or (want["depth_attention_ctx_wgmma"], want["depth_attention_ctx_cluster"],
                            want["flash_attention"]) != (350, 150, 250):
        raise AssertionError(f"phase 12 (b) rank {mesh.rank}: launches {launches}, expected "
                             f"{want} (K1 350 + 150, K2 250, K4 the census)")
    return dict(eps=eps.cpu(), latents=latents.cpu(), images=images.cpu(), volumes=volumes,
                launches=launches, avatar_s=ev0.elapsed_time(ev1) / 1e3, host_s=host_s,
                serving_peak=torch.cuda.max_memory_allocated(), collectives=stats,
                census=census)


def train_inputs(model):
    """(c)'s global batch (phase 6's, B=TRAIN_BATCH) and the global draws
    of its two steps."""
    from morphablediffusion_torch.utils.config import Config

    batch = flagship_batch(Config(), model.device, seed=2, B=TRAIN_BATCH, with_targets=True)
    draws = [model.draw_training_noise(TRAIN_BATCH, torch.Generator(model.device).manual_seed(s))
             for s in PAR_TRAIN_SEEDS]
    return batch, draws


def rank_training(mesh):
    """(c) on one rank: the ten leaves' gradients of one loss and backward
    (the ranks' mean), then two Trainer.train_steps on the rank's rows of
    the global batch with the global draws (the first one's GroupNorm calls
    counted). Returns the losses, grad norms, leaves, optimizer-state bytes,
    peak memory, the two steps' ms and the census."""
    from morphablediffusion_torch.parallel import shard_batch
    from morphablediffusion_torch.parallel.collectives import all_reduce_sum
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils.config import Config

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(Config(), seed=0, mesh=mesh)
    model = trainer.model
    batch, draws = train_inputs(model)
    local = shard_batch(batch, mesh)
    params = dict(model.named_parameters())
    model.training_loss(local, draws=trainer.local_draws(draws[0])).backward()
    leaves = {n: (all_reduce_sum(params[n].grad, mesh) / mesh.world).cpu()
              for n in NAMED_LEAVES}
    model.zero_grad(set_to_none=True)
    metrics = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    census = gn_census(lambda: metrics.append(trainer.train_step(local, draws=draws[0])))
    metrics.append(trainer.train_step(local, draws=draws[1]))
    ev1.record()
    torch.cuda.synchronize()
    return dict(train_loss=[float(m["loss"]) for m in metrics],
                grad_norm=[float(m["grad_norm"]) for m in metrics], leaves=leaves,
                opt_bytes=trainer.optimizer_bytes(), train_peak=torch.cuda.max_memory_allocated(),
                train_ms=ev0.elapsed_time(ev1) / len(draws), train_census=census)


def phase12_rank(rank: int, world: int, backend: str, init_file: str, out: str) -> None:
    """A spawned rank of (b) and (c): its mesh (`backend`, the card
    rank % device_count), rank_sampling then rank_training; the results to
    out/rank<r>.pt."""
    from morphablediffusion_torch.parallel import close_mesh, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(backend, "cuda", rank=rank, world=world,
                       init_method=f"file://{init_file}")
    try:
        res = rank_sampling(mesh)
        torch.cuda.empty_cache()
        res.update(rank_training(mesh))
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        close_mesh(mesh)


def spawn_ranks(world: int, backend: str, tmp: Path):
    """phase12_rank on `world` spawned processes; fails if one fails or has
    not ended within PAR_TIMEOUT (every rank is then killed). Returns their
    results by rank."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    init = tmp / f"init_{backend}"
    procs = [ctx.Process(target=phase12_rank, args=(r, world, backend, str(init), str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + PAR_TIMEOUT
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if hung or failed:
        raise AssertionError(f"phase 12 ranks under {backend}: hung {hung}, failed (rank, exit "
                             f"code) {failed}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def one_process_references(device):
    """The one-process results (b) and (c) are held to: the avatar of
    phase 4's seed (final latents and images), phase 6's loss and backward
    on (c)'s first draws (kernels; the mean of the ranks' halves of the
    batch, each a loss and backward: the batch split's own rounding; and
    twice the plain versions: the leaves' plain-vs-plain gap), and two
    Trainer steps on (c)'s draws with the optimizer-state bytes after them,
    with the kernels and, from the same starting state, twice with the
    plain versions: each step's own plain-vs-plain gap."""
    from morphablediffusion_torch.parallel import Mesh, shard_batch
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils.config import Config

    cfg = Config()
    model = serving_model(cfg, device, seed=0)
    batch = flagship_batch(cfg, device, seed=0)
    sampler = SyncDDIMSampler(model, sample_steps=cfg.model.sample_steps)
    images, latents = sampler.sample(batch, cfg.model.cfg_scale,
                                     generator=torch.Generator(device).manual_seed(1))
    ref = dict(images=images.cpu(), latents=latents.cpu())
    del model, sampler, images, latents
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, seed=0)
    model = trainer.model
    batch, draws = train_inputs(model)
    params = dict(model.named_parameters())

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model.training_loss(batch, draws=draws[0])
        loss.backward()
        torch.cuda.synchronize()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for _, p in trainer.grad_params() if p.grad is not None))
        return (float(loss.detach()), float(norm),
                {n: params[n].grad.float().cpu() for n in NAMED_LEAVES})

    ref["loss_k"], ref["norm_k"], ref["leaves_k"] = loss_and_grads()
    # the batch split alone: the mean of the ranks' halves, in this process
    halves = []
    for r in range(PAR_RANKS):
        rows = Mesh(r, PAR_RANKS, device)
        model.zero_grad(set_to_none=True)
        loss = model.training_loss(shard_batch(batch, rows), draws=shard_batch(draws[0], rows))
        loss.backward()
        halves.append((float(loss.detach()), {n: params[n].grad.float().cpu()
                                              for n in NAMED_LEAVES}))
    ref["loss_s"] = sum(h[0] for h in halves) / PAR_RANKS
    ref["leaves_s"] = {n: sum(h[1][n] for h in halves) / PAR_RANKS for n in NAMED_LEAVES}
    with plain_versions():
        ref["loss_p"], ref["norm_p"], ref["leaves_p"] = loss_and_grads()
        ref["loss_r"], ref["norm_r"], ref["leaves_r"] = loss_and_grads()
    model.zero_grad(set_to_none=True)
    metrics = [trainer.train_step(batch, draws=d) for d in draws]
    ref.update(train_loss=[float(m["loss"]) for m in metrics],
               grad_norm=[float(m["grad_norm"]) for m in metrics],
               opt_bytes=trainer.optimizer_bytes())
    del trainer, model, params, metrics
    torch.cuda.empty_cache()
    # the two steps with the plain versions, twice, each from a new Trainer
    # of the same seed: the second step's gap follows an AdamW update and
    # the training scatter's index_add_ atomics, which one backward's does not
    for key in ("plain_steps", "plain_steps_r"):
        trainer = Trainer(cfg, seed=0)
        with plain_versions():
            metrics = [trainer.train_step(batch, draws=d) for d in draws]
        ref[key] = ([float(m["loss"]) for m in metrics],
                    [float(m["grad_norm"]) for m in metrics])
        del trainer, metrics
        torch.cuda.empty_cache()
    return ref


def psnr_u8(a, b) -> float:
    """PSNR in dB of two images in [-1, 1] after the CLI's uint8 rounding."""
    to8 = lambda x: ((torch.as_tensor(x).float().clamp(-1, 1) + 1) * 127.5).round()
    mse = float(((to8(a) - to8(b)) ** 2).mean())
    return 10 * math.log10(255 ** 2 / max(mse, 1e-12))


def step_bounds(ref):
    """(c)'s bounds on the relative gap of the ranks' Trainer step i to one
    process's, for the loss and for the grad norm: NOISE_FACTOR x step i's
    run-to-run gap plus the floor (REL_TRAIN_LOSS, REL_TRAIN_GRAD). The gap
    is the largest of the three between one process's runs of the two
    steps from the same start: with the kernels, and twice with the plain
    versions. One pair of runs can land far closer than their spread
    (2.2e-5 against 1.75e-3 on the second step's grad norm), and a bound
    from it failed 3 of 16 (ranks, one process) pairs of
    tests/rank_step_noise.py."""
    runs = [(ref["train_loss"], ref["grad_norm"]), ref["plain_steps"], ref["plain_steps_r"]]
    rel = lambda a, b: abs(a - b) / abs(b)

    def bounds(q, floor):
        return [NOISE_FACTOR * max(rel(a[q][i], b[q][i]) for a, b in
                                   ((runs[1], runs[0]), (runs[2], runs[0]), (runs[2], runs[1])))
                + floor for i in range(len(runs[0][q]))]

    return bounds(0, REL_TRAIN_LOSS), bounds(1, REL_TRAIN_GRAD)


def check_ranks(label, ranks, ref, host_staged: bool):
    """(b) and (c) of the ranks against the one-process references: the
    CFG step at phase 3's gates, the volumes bitwise equal, the avatar's
    final latent and images, the training steps at phase 6's gates (step i
    within 2x step i's run-to-run gap plus its floor, `step_bounds`), the
    optimizer state per rank."""
    eps_k, eps_p, eps32 = STEP_EPS["phase 3"]
    r0, n = ranks[0], len(ranks)
    step_err = rel_l2(r0["eps"], eps_k)
    err_w, err_p = rel_l2(r0["eps"], eps32), rel_l2(eps_p, eps32)
    lat_err = rel_l2(r0["latents"], ref["latents"])
    psnr = psnr_u8(r0["images"], ref["images"])
    same_volumes = all(r["volumes"] == r0["volumes"] for r in ranks)
    log(f"{label} (b) one CFG step on {n} ranks: eps rel_l2 vs one process {step_err:.3e} "
        f"(bound {REL_L2_STEP}); vs the fp32 model {err_w:.3e} (bound {STEP_VS_FP32_RATIO} x "
        f"plain bf16's {err_p:.3e}); the spatial volumes bitwise equal on every rank: "
        f"{same_volumes} ({len(r0['volumes'])} a rank)")
    how = ("staged through the host under gloo, nothing of NCCL" if host_staged
           else "NCCL, the host's enqueue")
    for r, res in enumerate(ranks):
        st = res["collectives"]
        log(f"  rank {r}: avatar {res['avatar_s']:.3f} s (CUDA events), {res['host_s']:.3f} s "
            f"host clock, peak {res['serving_peak'] / 2**30:.2f} GiB; launches "
            f"{res['launches']}; collectives {st['calls']} calls, {st['bytes'] / 2**20:.1f} MiB "
            f"in, {st['seconds'] * 1e3 / 50:.3f} ms a step by the host clock ({how})")
    log(f"{label} (b) the avatar on {n} ranks against one process: final latent rel_l2 "
        f"{lat_err:.4e} (bound {PAR_LATENT_MAX_REL_L2}), images PSNR {psnr:.2f} dB (bound "
        f"{PAR_MIN_PSNR})")
    # phase 6's gates: NOISE_FACTOR x the plain versions' run-to-run gap plus
    # the floor. Logged beside: the batch split alone in one process (the
    # ranks' halves averaged against the whole batch), and the ranks
    # against that split
    rel = lambda a, b: abs(a - b) / abs(b)
    (p_loss, p_norm), (r_loss, r_norm) = ref["plain_steps"], ref["plain_steps_r"]
    loss_bounds, norm_bounds = step_bounds(ref)
    leaf_gap = {k: rel_l2(r0["leaves"][k], ref["leaves_k"][k]) for k in NAMED_LEAVES}
    split_gap = {k: rel_l2(ref["leaves_s"][k], ref["leaves_k"][k]) for k in NAMED_LEAVES}
    ranks_vs_split = {k: rel_l2(r0["leaves"][k], ref["leaves_s"][k]) for k in NAMED_LEAVES}
    leaf_bound = {k: NOISE_FACTOR * rel_l2(ref["leaves_r"][k], ref["leaves_p"][k])
                  + REL_TRAIN_LEAF for k in NAMED_LEAVES}
    loss_gaps = [rel(a, b) for a, b in zip(r0["train_loss"], ref["train_loss"])]
    norm_gaps = [rel(a, b) for a, b in zip(r0["grad_norm"], ref["grad_norm"])]
    ratio = [r["opt_bytes"] / ref["opt_bytes"] for r in ranks]
    fmt = lambda xs: "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"
    log(f"{label} (c) two train steps on {n} ranks, global batch {TRAIN_BATCH}: losses "
        f"{r0['train_loss']} vs one process {ref['train_loss']} (rel by step "
        f"{fmt(loss_gaps)}, bounds {fmt(loss_bounds)}; the plain versions twice "
        f"{p_loss} / {r_loss}; the split alone {rel(ref['loss_s'], ref['loss_k']):.2e}); "
        f"grad norms {r0['grad_norm']} vs {ref['grad_norm']} (rel by step {fmt(norm_gaps)}, "
        f"bounds {fmt(norm_bounds)}; the plain versions twice {p_norm} / {r_norm}); AdamW "
        f"moments per rank {[r['opt_bytes'] for r in ranks]} B = "
        f"{[round(x, 4) for x in ratio]} of one "
        f"process's {ref['opt_bytes']} B (bound 0.51)")
    for r, res in enumerate(ranks):
        log(f"  rank {r}: {res['train_ms']:.1f} ms a step (CUDA events, the process's first "
            f"two), peak {res['train_peak'] / 2**30:.2f} GiB")
    for k in NAMED_LEAVES:
        log(f"  grad rel_l2 {n} ranks vs one process {leaf_gap[k]:.3e} (bound "
            f"{leaf_bound[k]:.3e}; the split alone {split_gap[k]:.3e}, the ranks vs the split "
            f"in one process {ranks_vs_split[k]:.3e})  {k}")
    bad = []
    if not (step_err <= REL_L2_STEP and err_w <= STEP_VS_FP32_RATIO * err_p):
        bad.append("the CFG step")
    if not same_volumes:
        bad.append("the spatial volumes differ between the ranks")
    if not (lat_err <= PAR_LATENT_MAX_REL_L2 and psnr >= PAR_MIN_PSNR):
        bad.append("the avatar")
    if not (all(g <= b for g, b in zip(loss_gaps, loss_bounds))
            and all(g <= b for g, b in zip(norm_gaps, norm_bounds))
            and all(leaf_gap[k] <= leaf_bound[k] for k in NAMED_LEAVES)):
        bad.append("the training steps")
    if not all(x <= 0.51 for x in ratio):
        bad.append("the optimizer state per rank")
    if bad:
        raise AssertionError(f"{label}: {bad}")


def torchrun(args, nproc: int = PAR_RANKS):
    """`python -m torch.distributed.run --standalone` of a module with
    `nproc` ranks, under PAR_TIMEOUT; returns its stdout, raises on
    failure."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        f"--nproc_per_node={nproc}", "-m", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=PAR_TIMEOUT)
    if r.returncode != 0:
        raise AssertionError(f"torchrun {args[0]} exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-5000:]}")
    return r.stdout


def read_strip(path: Path):
    from PIL import Image

    return torch.from_numpy(np.asarray(Image.open(path)).astype(np.float32))


def cli_ranks(tmp: Path):
    """(b) the generate_face CLI with --view_parallel under torchrun on 2
    ranks sharing the card (gloo), on phase 8's documented inputs with
    seeded weights (no W8A8), against the one-process CLI: the strips'
    PSNR, and rank 0 alone writing."""
    from morphablediffusion_torch.apps import generate_face as gf

    common = ["--input_img", CLI_INPUT, "--mesh", CLI_MESH, "--cfg", CLI_CONFIG, "--ckpt",
              "random", "--no_mica_alignment"]
    t0 = time.perf_counter()
    run_cli(gf.main, common + ["--output_dir", str(tmp / "one")])
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = torchrun(["morphablediffusion_torch.apps.generate_face", *common, "--output_dir",
                    str(tmp / "two"), "--view_parallel", "--dist_backend", "gloo",
                    "--prepare_neus2_data"])
    two_s = time.perf_counter() - t0
    name = f"{Path(CLI_INPUT).stem}_mesh.png"
    one, two = read_strip(tmp / "one" / name), read_strip(tmp / "two" / name)
    mse = float(((one - two) ** 2).mean())
    psnr = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
    writes = out.count("wrote ")
    log(f"phase 12 (b) generate_face --view_parallel under torchrun, {PAR_RANKS} ranks on one "
        f"card (gloo): {two_s:.1f} s host clock (one process {one_s:.1f} s); strip PSNR "
        f"{psnr:.2f} dB against one process (bound {PAR_MIN_PSNR}); {writes} writes (rank 0)")
    for line in out.splitlines():
        if line.startswith(("rank ", "seconds:")):
            log(f"  {line}")
    if not (psnr >= PAR_MIN_PSNR and writes == 2 and one.shape == two.shape
            and (tmp / "two" / "neus2_data").is_dir()):
        raise AssertionError(f"phase 12 (b) CLI: PSNR {psnr:.2f}, {writes} writes")


def train_cli_ranks(tmp: Path):
    """(c) train.py under torchrun on 2 ranks sharing the card (gloo): 2
    steps of synth_scratch on a small synthetic tree and a checkpoint that
    rank 0 alone writes, then resumed in this process (world 1) for a third
    step."""
    import yaml

    from morphablediffusion_torch.apps import train as train_app
    from morphablediffusion_torch.tools import make_synthetic_facescape

    root = tmp / "synth"
    run_cli(make_synthetic_facescape.main, [
        "--out", str(root), "--subjects", "3", "--expressions", "2", "--views",
        str(SYNTH_VIEWS), "--image_size", str(SYNTH_SIZE)])
    raw = yaml.safe_load(SYNTH_CONFIG.read_text())
    uid = lambda s, e: f"{s:03d}/{e:02d}"
    raw["data"].update(data_dir=str(root / "data"), flame_assets_dir=str(root / "flame"),
                       uids=[uid(s, e) for s in (1, 2) for e in (1, 2)],
                       val_uids=[uid(3, 1)], num_workers=2, batch_size=2)
    raw["train"].update(val_check_interval=0, log_every=1, max_steps=2)
    cfg = tmp / "synth_dp.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    args = ["-b", str(cfg), "-l", str(tmp / "runs"), "-n", "dp"]
    t0 = time.perf_counter()
    out = torchrun(["morphablediffusion_torch.apps.train", *args, "--dist_backend", "gloo"])
    dp_s = time.perf_counter() - t0
    ckpt = tmp / "runs" / "dp" / "ckpt"
    files = sorted(p.name for p in ckpt.rglob("*.pt"))
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    log(f"phase 12 (c) train.py under torchrun, {PAR_RANKS} ranks on one card (gloo), batch 2 a "
        f"rank: {dp_s:.1f} s host clock; step lines {steps}; checkpoint files {files}")
    text, resume_s = run_cli(train_app.main, args + ["--resume", "--max_steps", "3"])
    log(f"  resumed in one process: {resume_s:.1f} s")
    if (len(steps) != 2 or files != ["params.pt", "state.pt"]
            or (ckpt / "last" / "step").read_text() != "3"
            or "resumed from step 2" not in text or "step 3 loss" not in text):
        raise AssertionError(f"phase 12 (c) train.py: steps {steps}, files {files}, resume "
                             f"{text[-500:]}")


def nccl_one_rank(tmp: Path, device):
    """(d) a one-rank NCCL group: (b)'s CFG step and (c)'s train step through
    the NCCL collectives against world 1 (no group). The train step's gradients are
    computed once and given to both optimizers (the backward has no
    deterministic mode for every op); eps, loss, grad norm and the trainable
    parameters after the step within NCCL_MAX_REL_L2."""
    from morphablediffusion_torch.parallel import close_mesh, create_mesh
    from morphablediffusion_torch.parallel.collectives import STATS, reset_stats
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils.config import Config

    cfg = Config()
    mesh = create_mesh("nccl", "cuda", rank=0, world=1, init_method=f"file://{tmp / 'nccl1'}")
    try:
        reset_stats()
        model = serving_model(cfg, device, seed=0)
        batch = flagship_batch(cfg, device, seed=0)
        # the serving step scatters its mesh voxels in order: two calls of
        # it differ by the collectives alone
        with torch.inference_mode():
            prep = model.prepare_inference(batch)
            eps1 = one_step(model, batch, prep=prep)
            eps_n = one_step(model, batch, prep=prep, mesh=mesh)
        step_err = rel_l2(eps_n, eps1)
        del model, prep
        torch.cuda.empty_cache()

        one, ranked = Trainer(cfg, seed=0), Trainer(cfg, seed=0, mesh=mesh)
        batch, draws = train_inputs(one.model)
        loss = one.model.training_loss(batch, draws=draws[0])
        loss.backward()
        theirs = dict(ranked.model.named_parameters())
        for n, p in one.model.named_parameters():
            if p.grad is not None:
                theirs[n].grad = p.grad.clone()
        m_n = ranked.apply_gradients(loss.detach())
        m_1 = one.apply_gradients(loss.detach())
        names = [n for n, _ in one.grad_params()]
        flat = lambda t: torch.cat([dict(t.model.named_parameters())[n].detach().reshape(-1)
                                    for n in names])
        param_err = rel_l2(flat(ranked), flat(one))
        errs = {"eps": step_err, "loss": rel_l2(m_n["loss"], m_1["loss"]),
                "grad_norm": rel_l2(m_n["grad_norm"], m_1["grad_norm"]),
                "parameters": param_err}
        log(f"phase 12 (d) a one-rank NCCL group against world 1: rel_l2 "
            f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (bound {NCCL_MAX_REL_L2}); "
            f"{STATS['calls']} NCCL collectives, {STATS['bytes'] / 2**30:.2f} GiB in")
        if not all(v <= NCCL_MAX_REL_L2 for v in errs.values()) or STATS["calls"] == 0:
            raise AssertionError(f"phase 12 (d) one-rank NCCL: {errs}")
        del one, ranked, theirs, loss
        torch.cuda.empty_cache()
    finally:
        close_mesh(mesh)


def parallel_kernels(cfg, device, censuses):
    """(a) the kernels at a rank's shapes: K1 and K2 at serving on one of
    W = 2 and 4 ranks (K1 logs its design, plan and the clusters the card
    holds), the training kernels at TRAIN_BATCH / 2 a rank, and K4 at every
    shape of the ranks' censuses ([(label, census)]); each against its
    plain version at phase 2's gates."""
    t0 = time.perf_counter()
    g = torch.Generator(device).manual_seed(4)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device=device) * std).bfloat16()
    with torch.inference_mode():
        for world in PAR_WORLDS:
            k1, k2 = per_rank_shapes(cfg, world)
            check_k1(k1, device, rn, 10, f"serving, one of {world} ranks")
            check_k2(k2, device, rn, 10, f"serving, one of {world} ranks")
    check_train_kernels(train_shapes(cfg, TRAIN_BATCH // PAR_RANKS), device)
    with torch.inference_mode():
        check_group_norm(censuses, device)
    log(f"phase 12 (a) kernels at the per-rank shapes: {time.perf_counter() - t0:.1f} s")


def parallel_phase(device, kernels):
    """Phase 12: more than one rank ((a) - (d) in the module docstring)."""
    from morphablediffusion_torch.parallel.mesh import Mesh
    from morphablediffusion_torch.utils.config import Config

    t_phase = time.perf_counter()
    cfg = Config()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ref = one_process_references(device)
        log(f"phase 12 one-process references: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ranks = spawn_ranks(PAR_RANKS, "gloo", tmp)
        log(f"phase 12 (b), (c) {PAR_RANKS} spawned ranks on one card (gloo): "
            f"{time.perf_counter() - t0:.1f} s")
        check_ranks("phase 12 gloo", ranks, ref, host_staged=True)
        censuses = [(f"one of {PAR_RANKS} ranks", ranks[0]["census"]),
                    (f"training, one of {PAR_RANKS} ranks", ranks[0]["train_census"])]
        model = serving_model(cfg, device, seed=0)
        batch = flagship_batch(cfg, device, seed=0)
        for world in PAR_WORLDS[1:]:  # a rank's shapes, without its collectives
            censuses.append((f"one of {world} ranks",
                             avatar_census(model, batch, Mesh(0, world, device))[0]))
        del model
        torch.cuda.empty_cache()
        parallel_kernels(cfg, device, censuses)
        cli_ranks(tmp)
        train_cli_ranks(tmp)
        nccl_one_rank(tmp, device)
        if torch.cuda.device_count() >= PAR_RANKS:
            (tmp / "nccl").mkdir()
            ranks = spawn_ranks(PAR_RANKS, "nccl", tmp / "nccl")
            check_ranks("phase 12 nccl, a card a rank", ranks, ref, host_staged=False)
        else:
            log(f"nccl multi-card: not run ({torch.cuda.device_count()} card)")
    log(f"phase 12 more than one rank: {time.perf_counter() - t_phase:.1f} s")


# phase 15: the JAX package's Orbax run directories, read without JAX
RESUME_BATCH = 2  # (e)'s samples a step (tests/tiny.py's config)
RESUME_SEED = 21  # (e)'s draws
FULL_RESUME_STEP = 3  # (f)'s micro-steps before the export (accumulation 2)


def sha256_leaf(a) -> str:
    """sha256 of a leaf's bytes (bf16 as its uint16 bits), as the fixture's
    list holds it."""
    import hashlib

    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint16).numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def orbax_export_phase(device, kernels, k1_shapes, k2_shape, serving_census, tmp: Path):
    """Phase 15 (b), (c): make_orbax_run writes Config()'s seeded fp32 model
    as a JAX params export; generate_face serves it (`--ckpt <dir>`) and,
    in the same process, the same seeded weights (`--ckpt random`): the two
    strips bitwise equal, the launches per avatar."""
    from morphablediffusion_torch.tools import make_orbax_run
    from morphablediffusion_torch.utils.config import Config

    ckpt = tmp / "run" / "ckpt"
    text, seconds = run_cli(make_orbax_run.main, ["--out", str(ckpt)])
    torch.cuda.empty_cache()
    written = json.loads(text.strip().splitlines()[-1])
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    log(f"phase 15 (b) make_orbax_run: Config()'s seeded fp32 model (seed 0) as a JAX params "
        f"export, {size / 2**30:.3f} GiB on disk ({written['bytes']} B of OCDBT nodes and "
        f"chunks) in {written['seconds']:.2f} s ({seconds:.2f} s with the model's build and "
        f"seeding)")
    use_main = cli_entry()
    cfg = Config()
    strips = {}
    for label, ck in (("JAX Orbax export", str(ckpt)), ("in-process seeded weights", "random")):
        out = tmp / ("orbax" if ck != "random" else "random")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        views, report = cli_avatar(use_main, out, CLI_INPUT, CLI_MESH, ck,
                                   ("--no_mica_alignment",))
        host_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        want = avatar_launches(kernels, cfg, k1_shapes, k2_shape, serving_census)
        check_cli_avatar(f"phase 15 (c) generate_face --ckpt {label}", cfg, views, report,
                         launches, want, out if use_main else None, Path(CLI_INPUT).stem,
                         False)
        strip = out / f"{Path(CLI_INPUT).stem}_mesh.png"
        strips[ck] = (views, strip.read_bytes() if use_main else None)
        if ck != "random":
            load = report["seconds"]["load"]
            log(f"phase 15 (c) the export read and loaded in {load:.3f} s "
                f"({size / 2**30 / load:.3f} GiB/s of the {size / 2**30:.3f} GiB on disk), "
                f"the avatar {report['seconds']['sample']:.3f} s (CUDA events), the CLI call "
                f"{host_s:.2f} s host clock")
        del views
        torch.cuda.empty_cache()
    (v_o, png_o), (v_r, png_r) = strips[str(ckpt)], strips["random"]
    same = bool(np.array_equal(v_o, v_r)) and png_o == png_r
    log(f"phase 15 (c) the Orbax export's avatar bitwise equal to the in-process one: views "
        f"{bool(np.array_equal(v_o, v_r))}, strip files "
        f"{'not written (run(...))' if png_o is None else png_o == png_r}")
    if not same:
        raise AssertionError(f"phase 15 (c): the avatars differ (max |diff| "
                             f"{float(np.abs(v_o - v_r).max()):.3e})")
    shutil.rmtree(tmp / "run")  # (f)'s state takes the disk next


def orbax_fixture_phase(tmp: Path):
    """Phase 15 (d): the committed JAX-written fixture read on the card,
    every leaf's sha256 the committed one. Returns its ckpt directory."""
    from morphablediffusion_torch.tools import make_orbax_run as mor
    from morphablediffusion_torch.utils import orbax_reader

    ckpt = mor.unpack_fixture(tmp / "fixture")
    want = json.loads(mor.FIXTURE_LEAVES.read_text())
    for kind in ("params", "last"):
        t0 = time.perf_counter()
        step_dir = ckpt / kind / str(mor.FIXTURE_STEP)
        tree = orbax_reader.read_tree(step_dir)
        got = {".".join(map(str, p)): sha256_leaf(a) for p, a in tree.items()}
        height = orbax_reader.OcdbtDatabase(orbax_reader.step_dir_of(step_dir)).height
        bad = sorted(k for k in set(got) | set(want[kind]) if got.get(k) != want[kind].get(k))
        log(f"phase 15 (d) the JAX-written fixture {kind}/{mor.FIXTURE_STEP}: {len(got)} leaves "
            f"({sum(isinstance(a, torch.Tensor) for a in tree.values())} bf16), b-tree height "
            f"{height}, read in {time.perf_counter() - t0:.2f} s; sha256 equal to the committed "
            f"list: {len(got) - len(bad)} of {len(want[kind])}")
        if bad:
            raise AssertionError(f"phase 15 (d) {kind}: leaves that differ {bad[:5]}")
    return ckpt


def orbax_resume_phase(device, kernels, fixture: Path):
    """Phase 15 (e): `train --resume`'s restore (CheckpointManager.restore)
    of the fixture's TrainState into the port's Trainer on the card, then
    the next micro-step (it completes an accumulation: an AdamW step on the
    resumed moments) in bf16 with the kernels, twice with the plain
    versions, and in fp32 with the plain versions, each from the same
    restored state. The plain versions are deterministic at this size (the
    two plain runs are logged), so the gate is phase 6's in the form
    `check_train_step_vs_fp32` gives it for such a path: the kernels' loss,
    grad norm and parameter update no further from the fp32 step than
    STEP_VS_FP32_RATIO x the plain versions' distance plus phase 6's
    floors."""
    from morphablediffusion_torch.tools.make_orbax_run import fixture_config
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils.checkpoint import CheckpointManager

    runs = {}
    for label in ("kernels", "plain", "plain again", "fp32"):
        cfg = fixture_config()
        cfg.model.dtype = "float32" if label == "fp32" else "bfloat16"  # the kernels' bf16
        trainer = Trainer(cfg, device=device)
        step = CheckpointManager(fixture).restore(trainer)
        before = {n: p.detach().float().clone() for n, p in trainer.model.named_parameters()}
        batch = flagship_batch(cfg, device, seed=2, B=RESUME_BATCH, with_targets=True)
        draws = trainer.model.draw_training_noise(
            RESUME_BATCH, torch.Generator(device).manual_seed(RESUME_SEED))
        for k in kernels:
            k.launches = 0
        with plain_versions() if label != "kernels" else contextlib.nullcontext():
            m = trainer.train_step(batch, draws=draws)
        torch.cuda.synchronize()
        update = torch.cat([(p.detach().float() - before[n]).reshape(-1)
                            for n, p in trainer.model.named_parameters()])
        runs[label] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]), update=update,
                           launches={k.name: k.launches for k in kernels},
                           steps=(step, trainer.step, trainer.opt_step))
        del trainer, before
    k, p, r, f = (runs[x] for x in ("kernels", "plain", "plain again", "fp32"))
    rel = lambda a, b: abs(a - b) / abs(b)
    gaps = {"loss": (rel(k["loss"], f["loss"]), rel(p["loss"], f["loss"]), REL_TRAIN_LOSS),
            "grad norm": (rel(k["norm"], f["norm"]), rel(p["norm"], f["norm"]), REL_TRAIN_GRAD),
            "update": (rel_l2(k["update"], f["update"]), rel_l2(p["update"], f["update"]),
                       REL_TRAIN_LEAF)}
    bad = {n: g for n, g in gaps.items() if not g[0] <= STEP_VS_FP32_RATIO * g[1] + g[2]}
    steps = k["steps"]
    log(f"phase 15 (e) resumed the fixture's TrainState at step {steps[0]} (its widened tiny "
        f"config, accumulation 2) and took micro-step {steps[0]}: step/opt_step after {steps[1:]}; "
        f"loss kernels {k['loss']:.6f} plain {p['loss']:.6f} fp32 {f['loss']:.6f}; grad norm "
        f"{k['norm']:.5f} / {p['norm']:.5f} / {f['norm']:.5f}; |update| "
        f"{float(k['update'].norm()):.3e}; plain vs plain: loss rel "
        f"{rel(r['loss'], p['loss']):.2e}, grad norm rel {rel(r['norm'], p['norm']):.2e}, "
        f"update rel_l2 {rel_l2(r['update'], p['update']):.2e}; launches with the kernels "
        f"{k['launches']}")
    for n, (gk, gp, floor) in gaps.items():
        log(f"  vs fp32: kernels {gk:.3e}, plain {gp:.3e} (bound "
            f"{STEP_VS_FP32_RATIO * gp + floor:.3e})  {n}")
    if (bad or not math.isfinite(k["loss"]) or steps[1:] != (steps[0] + 1, 2)
            or not float(k["update"].norm()) > 0 or sum(k["launches"].values()) == 0):
        raise AssertionError(f"phase 15 (e): against the fp32 step {bad}, steps {steps}, "
                             f"launches {k['launches']}")


class PeakRss:
    """The host's resident set size, sampled on a thread every few
    milliseconds while in the block: `before` and `peak`, in bytes."""

    def __enter__(self):
        import threading

        self.before = self.peak = rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())

    def line(self) -> str:
        return (f"host RSS {self.before / 2**30:.2f} GiB before, peak {self.peak / 2**30:.2f} "
                f"(+{(self.peak - self.before) / 2**30:.2f})")


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def same_train_state(a, b) -> dict:
    """Whether two one-process Trainers hold the same state, bitwise: the
    parameters, each AdamW moment and step, the accumulator, the
    counters."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    moments = steps = True
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        for x, y in zip(ga["params"], gb["params"]):
            sa, sb = a.optimizer.state[x], b.optimizer.state[y]
            moments &= all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))
            steps &= float(sa["step"]) == float(sb["step"])
    acc_a, acc_b = a._acc or {}, b._acc or {}
    return {"params": pa.keys() == pb.keys() and all(torch.equal(pa[n], pb[n]) for n in pa),
            "moments": moments, "adamw steps": steps,
            "accumulator": acc_a.keys() == acc_b.keys() and all(
                torch.equal(acc_a[n], acc_b[n]) for n in acc_a),
            "counters": (a.step, a.opt_step) == (b.step, b.opt_step)}


def state_bytes(trainer) -> int:
    """Bytes of a one-process Trainer's state: parameters, AdamW moments,
    accumulator."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return (size(trainer.model.parameters())
            + size(t for st in trainer.optimizer.state.values() for k, t in st.items()
                   if k != "step")
            + size((trainer._acc or {}).values()))


def orbax_full_resume_phase(device, kernels, tmp: Path):
    """Phase 15 (f) (the module docstring)."""
    import yaml

    from morphablediffusion_torch.apps import train as train_app
    from morphablediffusion_torch.tools import make_orbax_run, make_synthetic_facescape
    from morphablediffusion_torch.training.trainer import Trainer
    from morphablediffusion_torch.utils.checkpoint import CheckpointManager
    from morphablediffusion_torch.utils.config import load_config

    root = tmp / "full"
    run_cli(make_synthetic_facescape.main, [
        "--out", str(root), "--subjects", "2", "--expressions", "1", "--views", "16",
        "--image_size", "256"])
    raw = yaml.safe_load(Path(CLI_CONFIG).read_text())
    raw["data"].update(data_dir=str(root / "data"), flame_assets_dir=str(root / "flame"),
                       uids=["001/01"], val_uids=["002/01"], batch_size=1, num_workers=2)
    raw["train"].update(accumulate_grad_batches=2, val_check_interval=0, log_every=1,
                        max_steps=FULL_RESUME_STEP + 1)
    cfg_path = tmp / "full.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = load_config(cfg_path)
    ckpt = tmp / "runs" / "jax_full" / "ckpt"

    writer = Trainer(cfg, device=device, seed=0)
    batch = flagship_batch(cfg, device, seed=2, B=1, with_targets=True)
    for _ in range(FULL_RESUME_STEP):
        writer.train_step(batch)
    writer.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    nbytes = state_bytes(writer)
    t0 = time.perf_counter()
    make_orbax_run.export_train_state(writer, ckpt)
    write_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    log(f"phase 15 (f) make_orbax_run.export_train_state: configs/facescape.yaml's Trainer at "
        f"accumulation 2 after {FULL_RESUME_STEP} micro-steps of B=1 (opt_step "
        f"{writer.opt_step}) as the JAX train CLI's last/{FULL_RESUME_STEP}: "
        f"{nbytes / 2**30:.3f} GiB of state, {size / 2**30:.3f} GiB on disk in {write_s:.2f} s "
        f"({size / 2**30 / write_s:.3f} GiB/s); {shutil.disk_usage(tmp).free / 2**30:.0f} GiB "
        f"free on that disk")

    # the train CLI resumes it; its restore is timed, sampled and compared
    seen = {}
    restore = CheckpointManager.restore

    def restore_and_compare(mgr, trainer):
        with PeakRss() as rss:
            t0 = time.perf_counter()
            step = restore(mgr, trainer)
            torch.cuda.synchronize()
            seen["seconds"] = time.perf_counter() - t0
        seen["rss"], seen["same"] = rss, same_train_state(writer, trainer)
        return step

    for k in kernels:
        k.launches = 0
    CheckpointManager.restore = restore_and_compare
    try:
        with PeakRss() as rss_cli:
            text, cli_s = run_cli(train_app.main, ["-b", str(cfg_path), "-l", str(tmp / "runs"),
                                                   "-n", "jax_full", "--resume"])
    finally:
        CheckpointManager.restore = restore
    launches = {k.name: k.launches for k in kernels}
    del writer
    torch.cuda.empty_cache()
    line = next((ln for ln in text.splitlines()
                 if ln.startswith(f"step {FULL_RESUME_STEP + 1} loss ")), "")
    loss = float(line.split()[3]) if line else float("nan")
    rss, same = seen["rss"], seen["same"]
    log(f"phase 15 (f) train --resume on it: the restore {seen['seconds']:.2f} s "
        f"({size / 2**30 / seen['seconds']:.3f} GiB/s of the files), {rss.line()}; the "
        f"restored state bitwise equal to the writer's: {same}; the CLI call {cli_s:.1f} s "
        f"host clock ({rss_cli.line()}); '{line}'; launches {launches}")
    trained = ("depth_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
               "group_norm")
    if (not all(same.values()) or not math.isfinite(loss)
            or f"resumed from step {FULL_RESUME_STEP}" not in text
            or (ckpt / "last" / "step").read_text() != str(FULL_RESUME_STEP + 1)
            or not all(launches.get(n, 0) > 0 for n in trained)
            or rss.peak - rss.before > nbytes / 2):
        raise AssertionError(f"phase 15 (f): same {same}, loss {loss}, launches {launches}, "
                             f"restore RSS +{rss.peak - rss.before} B of a {nbytes} B state; "
                             f"{text[-800:]}")


def orbax_phase(device, kernels, k1_shapes, k2_shape, serving_census):
    """Phase 15 ((a) - (e) in the module docstring)."""
    from morphablediffusion_torch.utils import orbax_reader

    t_phase, seconds = time.perf_counter(), {}
    z = orbax_reader.zstd()
    v = z.version
    log(f"phase 15 (a) libzstd {z.path}, ZSTD_versionNumber {v} ({v // 10000}.{v // 100 % 100}."
        f"{v % 100}); the reader's only zstd decoder")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as tmp:
        tmp = Path(tmp)
        parts = (("(b), (c) export and serve", lambda: orbax_export_phase(
                    device, kernels, k1_shapes, k2_shape, serving_census, tmp)),
                 ("(d) fixture", lambda: orbax_fixture_phase(tmp)),
                 ("(e) resume", lambda: orbax_resume_phase(device, kernels,
                                                           tmp / "fixture" / "ckpt")),
                 ("(f) full-width resume", lambda: orbax_full_resume_phase(device, kernels,
                                                                           tmp)))
        for label, part in parts:
            t0 = time.perf_counter()
            part()
            seconds[label] = time.perf_counter() - t0
    log(f"phase 15 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; phase 15 "
        f"the JAX package's Orbax run directories: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from morphablediffusion_torch.ops import _cuda
    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import flash_attention as fa
    from morphablediffusion_torch.ops import group_norm as gn
    from morphablediffusion_torch.sampling import SyncDDIMSampler
    from morphablediffusion_torch.utils.config import Config

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    kernels = all_kernels()
    _cuda.build(kernels)
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        # ptxas's notes that it serialized wgmma (C7512, C7514), if any
        serialized = sum("wgmma.mma_async instructions are serialized" in ln
                         for ln in k.build_log.splitlines())
        log(f"  {k.name}: nvcc {k.build_seconds:.2f} s; {serialized} serialized-wgmma notes; "
            f"{regs}")
    # the cluster kernels: registers, shared memory, spills (any spill fails)
    log(f"  K1 cluster design resources: "
        f"{entry_resources(da.CLUSTER_KERNEL, 'md_ctx_cluster_kernel')}")
    log(f"  K3 resources: {entry_resources(da.DEPTH_KERNEL, 'md_depth_attn_kernel')}")
    log(f"  K4 resources: {entry_resources(gn.KERNEL, 'md_group_norm_kernel')}")
    nhwc = entry_resources(gn.KERNEL, "md_group_norm_kernel_nhwc")
    if nhwc is not None and nhwc.count("md_group_norm_kernel_nhwc") != 4:
        raise AssertionError(f"K4's channels-last instantiations: {nhwc}")

    cfg = Config()
    k1_shapes, k2_shape = main_path_shapes(cfg)
    tshapes = train_shapes(cfg, TRAIN_BATCH)

    # 2. kernels against their plain versions, at the serving shapes and at
    # the training shapes (K4 after phase 7, at the shapes of the censuses)
    t0 = time.perf_counter()
    with torch.inference_mode():
        checked = check_kernels(k1_shapes, k2_shape, device)
    for name, rows in check_train_kernels(tshapes, device).items():
        checked[name] = checked.get(name, []) + rows
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    # 3. one full-width step: bf16 with the kernels, bf16 with the plain
    # versions, and the fp32 model; the avatar's GroupNorm calls
    model, batch, _ = step_check(cfg, device, "phase 3")
    gn_avatar, gn_step = avatar_census(model, batch)
    censuses = [("serving", gn_avatar)]
    log(f"phase 3 GroupNorm census: {sum(gn_step.values())} calls per denoising step over "
        f"{len(gn_step)} shapes, {sum(gn_avatar.values())} per avatar over {len(gn_avatar)}; "
        f"channels-last {sum(n for k, n in gn_step.items() if k[6] == gn.NHWC)} a step, "
        f"{sum(n for k, n in gn_avatar.items() if k[6] == gn.NHWC)} an avatar")

    # 4. the full avatar; K4's channels-last launches as the census's, in
    # the warm-up and the timed avatar
    sampler = SyncDDIMSampler(model, sample_steps=cfg.model.sample_steps)
    want = avatar_launches(kernels, cfg, k1_shapes, k2_shape, gn_avatar)
    nhwc0 = gn.nhwc_launches
    _, _, launches = timed_avatar(sampler, batch, kernels, want, "phase 4")
    want_nhwc = 2 * sum(n for k, n in gn_avatar.items() if k[6] == gn.NHWC)
    log(f"phase 4 K4 channels-last launches: {gn.nhwc_launches - nhwc0} of two avatars "
        f"(census {want_nhwc}, of {2 * sum(gn_avatar.values())} GroupNorm calls)")
    if gn.nhwc_launches - nhwc0 != want_nhwc:
        raise AssertionError(f"K4 channels-last launches {gn.nhwc_launches - nhwc0}, the "
                             f"census {want_nhwc}")
    if ((want[da.WGMMA_KERNEL.name], want[da.CLUSTER_KERNEL.name], want[da.KERNEL.name])
            != (350, 150, 0) or want["flash_attention"] != 250
            or want[gn.KERNEL.name] != 5902):
        raise AssertionError(f"expected launches {want}")

    # 5. where one denoising step's device time goes, and the ordered
    # scatter's share of it
    profile_step(sampler, batch)
    scatter_cost(model, batch)
    del sampler, model
    torch.cuda.empty_cache()

    # 6. training
    expected = train_expected_launches(tshapes)
    train_launches, train_ms, train_peak, gn_train = train_phase(cfg, device, kernels,
                                                                 expected)
    censuses.append(("training", gn_train))
    torch.cuda.empty_cache()

    # 7. the other configurations
    for label, ocfg in other_configs().items():
        model, batch, _ = step_check(ocfg, device, f"phase 7 {label}")
        o_avatar, o_step = avatar_census(model, batch)
        censuses.append((label, o_step))
        if label != "spatial_volume":
            sampler = SyncDDIMSampler(model, sample_steps=ocfg.model.sample_steps)
            timed_avatar(sampler, batch, kernels,
                         avatar_launches(kernels, ocfg, k1_shapes, k2_shape, o_avatar),
                         f"phase 7 {label}", warmup=label == "thuman")
            del sampler
        del model
        torch.cuda.empty_cache()

    # 8. the generate_face CLI
    censuses.append(("cli_fine", cli_phase(device, kernels, k1_shapes, k2_shape, gn_avatar)))

    # 9. training complete, 10. the eval harness, 11. FLAME fitting (phase
    # 10's landmark net) and 13. the weight files and the tools (phase 9's
    # run, phase 10's tree)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_keep_") as keep:
        keep = Path(keep)
        censuses += training_complete(device, kernels, checked, card, keep)
        censuses += eval_phase(device, kernels, checked, keep)
        jobs = tools_jobs(keep)
        try:
            censuses += fitting_phase(device, kernels, keep)
            censuses += tools_phase(device, kernels, keep, jobs)
        finally:
            for job in jobs:
                job.stop()

    # K4 (phase 2) at every GroupNorm call the censuses found
    t0 = time.perf_counter()
    with torch.inference_mode():
        checked["group_norm"] = check_group_norm(censuses, device)
    log(f"K4 vs plain at {len({k for _, c in censuses for k in c})} shapes: "
        f"{time.perf_counter() - t0:.1f} s")

    # 12. more than one rank
    parallel_phase(device, kernels)

    # 15. the JAX package's Orbax run directories
    orbax_phase(device, kernels, k1_shapes, k2_shape, gn_avatar)

    # 14. results
    train_run = f"training: {TRAIN_STEPS} steps of B={TRAIN_BATCH} ({train_ms:.2f} ms each)"
    per_step = {n: c // TRAIN_STEPS for n, c in train_launches.items()}
    serving = lambda name: (launches[name], "serving", "avatar")
    training = lambda name: (train_launches[name], "training", train_run)
    entries = [
        kernel_entry(name, f"morphablediffusion_torch/csrc/{source}", replaces, checked[name],
                     *run(name), per_step[name])
        for name, source, replaces, run in (
            ("depth_attention_ctx_wgmma", "depth_attention_ctx.cu",
             "morphablediffusion_tpu/ops/depth_attention.py:236 (W=32, W=16)", serving),
            ("depth_attention_ctx_cluster", "depth_attention_ctx_cluster.cu",
             "morphablediffusion_tpu/ops/depth_attention.py:236 (W=8, W=4)", serving),
            ("flash_attention", "flash_attention.cu",
             "morphablediffusion_tpu/models/layers.py:277", serving),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:796 "
             "(_flash_attention_dkv_kernel, via models/layers.py:277)", training),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1146 "
             "(_flash_attention_dq_kernel, via models/layers.py:277)", training),
            ("depth_attention", "depth_attention.cu",
             "morphablediffusion_tpu/ops/depth_attention.py:56", training))
    ]
    entries.append(kernel_entry(
        "group_norm", "morphablediffusion_torch/csrc/group_norm.cu",
        "morphablediffusion_tpu/ops/group_norm.py:79", checked["group_norm"],
        launches[gn.KERNEL.name], "serving", "avatar", per_step[gn.KERNEL.name],
        peak_flops=PEAK_FP32_FLOPS, list_shapes=False))
    log(f"training peak allocated {train_peak / 2**30:.2f} GiB")
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
