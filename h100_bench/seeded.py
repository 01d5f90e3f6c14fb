"""The model's weights, made from the run's seed on the device.

One `torch.Generator` on the device draws every value in one call; each
leaf then takes its slice: kernels N(0, 1/fan_in), other dense leaves
(biases, embeddings) N(0, 0.02^2), normalization scales 1 + N(0, 0.1^2),
their shifts (and BatchNorm's running means) N(0, 0.1^2), BatchNorm's
running variances exp(N(0, 0.1^2)). Names and shapes come from the plain
reference (`reference.named_leaves`), which uses the flax names that the
measured program also uses, so the same dict loads into both.
"""

from __future__ import annotations

import math

import torch

from h100_bench import gen, reference

FROZEN_PREFIXES = ("first_stage.", "clip_image_encoder.")


def make_state(model_cfg: dict, seed: int, device, served_dtype=None, frozen_dtype=None):
    """{name: tensor} of every parameter. Dense leaves are rounded to
    `served_dtype` (serving: the configuration's dtype) or, for the frozen
    VAE and CLIP only, to `frozen_dtype` (training), and returned in that
    dtype; norm leaves stay float32. `as_float32()` gives the same values in
    float32 for the reference."""
    leaves = reference.named_leaves(model_cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    flat = torch.randn(total, generator=gen.generator(device, seed, "weights"), device=device)
    state, at = {}, 0
    for name, shape, kind, fan in leaves:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "norm_scale":
            v = 1.0 + 0.1 * z
        elif kind == "norm_shift":
            v = 0.1 * z
        elif kind == "bn_var":
            v = torch.exp(0.1 * z)
        else:
            v = z * (fan ** -0.5 if fan else 0.02)
            dt = frozen_dtype if name.startswith(FROZEN_PREFIXES) else None
            dt = served_dtype or dt
            if dt is not None:
                v = v.to(dt)
        state[name] = v.clone()
    return state


def as_float32(state):
    return {k: v.float() for k, v in state.items()}
