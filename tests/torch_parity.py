"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference. A parameter tree comes from the JAX
module's own `init` (its names and shapes); its values are then redrawn from
numpy with a seed, so that zero-initialized output convs do not hide a branch
from the comparison. The tree is carried to the port with
`weights.from_jax_params` and loaded with strict=True. Inputs are numpy
arrays handed to both sides; the port runs on the CPU in fp32.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from morphablediffusion_torch.utils import config as port_config
from morphablediffusion_torch.weights import flatten_tree, from_jax_params

torch.set_num_threads(2)


def port_model_config(jax_model_cfg) -> port_config.ModelConfig:
    """The JAX package's ModelConfig -> the port's own copy of it."""
    d = dataclasses.asdict(jax_model_cfg)
    unet = port_config.UNetConfig(**d.pop("unet"))
    clip = port_config.CLIPConfig(**d.pop("clip"))
    return port_config.ModelConfig(**d, unet=unet, clip=clip)


def seeded_tree(tree, seed: int = 0):
    """Same structure as `tree` (a flax variable tree or its eval_shape),
    numpy float32 values: norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2),
    kernels N(0, 1/fan_in), other 1-D leaves N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        shape = tuple(s.shape)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.02 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_into(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax {'params': ...} tree into a port module (strict)."""
    module.load_state_dict(from_jax_params(flatten_tree(params["params"]), device="cpu"), strict=True)
    return module.eval()


def tt(x) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cl(x: torch.Tensor) -> torch.Tensor:
    """channels-first (B, C, ...) -> channels-last (B, ..., C)."""
    return x.movedim(1, -1)


def cf(x) -> torch.Tensor:
    """channels-last (B, ..., C) array -> channels-first tensor."""
    return tt(x).movedim(-1, 1).contiguous()


def assert_close(actual, expected, tol: float):
    np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=tol, atol=tol)
