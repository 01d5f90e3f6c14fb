"""Weights of the PyTorch port: the JAX parameter bridge (both ways), seeded
weights and the serving cast.

The port's modules carry the flax parameter names (`unet.in_1_res.norm_in`),
so a JAX parameter tree maps key by key and `load_state_dict(strict=True)`
proves that every leaf is covered. `to_jax_layout` maps the other way, for
anything shaped like the parameters (gradients, optimizer moments), so they
compare leaf by leaf with the JAX package's.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

from morphablediffusion_torch.models import layers
from morphablediffusion_torch.models.mesh_voxel import BNActive, MaskedInstanceNorm
from morphablediffusion_torch.utils import resolve_device

# flax kernels of the ConvTranspose3dTorch convs, stored conv-style and
# spatially flipped: FrustumTV3DNet's up0-up2 and SpatialTime3DNet's
# conv7-conv9 (their other blocks' `conv` is a plain conv)
_TRANSPOSED = re.compile(r"(^|/)(up\d+|conv[789])/conv/kernel$")

# normalization modules: parameters seeded as scale 1 (and BNActive's
# running variance 1), the rest 0, and kept fp32 when the model is cast
NORM_MODULES = (layers.GroupNorm, layers.LayerNorm, MaskedInstanceNorm, BNActive)
_ONE_AT_INIT = ("weight", "var")


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays (a flax parameter tree) -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def from_jax_params(flat: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree flattened to '/'-joined paths (below 'params') ->
    a state_dict of the port's modules, fp32 on `device` (default the CUDA
    card; without one this raises unless device="cpu" is passed).

    Dense kernel (I, O) -> Linear weight (O, I); conv kernel (kh, kw, I, O)
    -> (O, I, kh, kw) and likewise in 3D; the ConvTranspose3dTorch kernel
    (k, k, k, I, O), stored flipped, -> ConvTranspose3d weight (I, O, k, k, k)
    with the flip undone; norm `scale` -> `weight`. Other leaves (CLIP's
    class_embedding, positional_embedding, proj) keep name and layout.
    """
    dev = resolve_device(device)
    sd = {}
    for path, arr in flat.items():
        parts = path.split("/")
        # bf16 leaves come as torch tensors (numpy has no bfloat16); the
        # layout change runs on `dev`, after the copy there
        if isinstance(arr, torch.Tensor):
            a = arr.to(dev, torch.float32, copy=True)
        else:
            a = torch.from_numpy(np.require(arr, np.float32, ["C", "W"])).to(dev)
        leaf = parts[-1]
        at = lambda name: ".".join(parts[:-1] + [name])
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.t()
            elif _TRANSPOSED.search(path):
                a = a.flip((0, 1, 2)).permute(3, 4, 0, 1, 2)
            elif a.ndim == 4:
                a = a.permute(3, 2, 0, 1)
            elif a.ndim == 5:
                a = a.permute(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"unexpected kernel rank at {path}: {tuple(a.shape)}")
            key = at("weight")
        elif leaf == "scale":
            key = at("weight")
        else:
            key = ".".join(parts)
        sd[key] = a.contiguous()
    return sd


def _fan_in(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """fan_in of a weight, taken from the shape it has in the JAX tree."""
    if isinstance(module, nn.ConvTranspose3d):  # JAX (k, k, k, I, O)
        return int(np.prod(p.shape[2:])) * p.shape[0]
    if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):  # JAX (.., I, O)
        return int(np.prod(p.shape[1:]))
    return p.shape[0]  # raw (I, O)-style leaves: positional_embedding, proj


@torch.no_grad()
def seeded_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter with seeded initializer-family values: norm
    scales (and BNActive's running variance) 1, their other parameters and
    all biases 0, kernels N(0, 1/fan_in) with fan_in from the JAX shape,
    other 1-D leaves N(0, 0.02^2). Draws from one torch.Generator on
    the model's device, in parameter order. Returns the model."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, NORM_MODULES):
                p.fill_(1.0 if name in _ONE_AT_INIT else 0.0)
            elif name == "bias":
                p.zero_()
            elif p.ndim >= 2:
                std = _fan_in(module, name, p) ** -0.5
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * std)
            else:
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
    return model


@torch.no_grad()
def cast_for_serving(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast matmul and conv weights (and biases, embeddings) to `dtype`;
    normalization parameters stay fp32 for the fp32 statistics path."""
    for module in model.modules():
        if isinstance(module, NORM_MODULES):
            continue
        for name, p in module.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model


def _jax_leaf(module: nn.Module, leaf: str, a: np.ndarray):
    """A port parameter's leaf name and array (port layout) -> the flax leaf
    name and the array in the JAX layout (a view where it can be)."""
    if leaf == "weight" and isinstance(module, NORM_MODULES):
        return "scale", a
    if leaf == "weight" and isinstance(module, nn.ConvTranspose3d):
        return "kernel", a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
    if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):
        return "kernel", a.transpose(tuple(range(2, a.ndim)) + (1, 0))
    return leaf, a


def _jax_paths(model: nn.Module, names, arrays):
    """{flax path below 'params': JAX-layout view} of the named arrays."""
    modules = dict(model.named_modules())
    out = {}
    for name, a in zip(names, arrays):
        mod_name, _, leaf = name.rpartition(".")
        leaf, a = _jax_leaf(modules[mod_name], leaf, a)
        parts = mod_name.split(".") if mod_name else []
        out["/".join(parts + [leaf])] = a
    return out


def to_jax_layout(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{port parameter name: tensor shaped like that parameter} (parameters,
    gradients, AdamW moments) -> {flax path below 'params': fp32 numpy array
    in the JAX layout}, the inverse of `from_jax_params`. The arrays are
    views (transposed, or flipped) of one fp32 host copy per tensor, so the
    export's transposes back to the torch layout copy nothing."""
    arrays = [t.detach().float().cpu().numpy() for t in tensors.values()]
    return _jax_paths(model, tensors.keys(), arrays)


def jax_shapes(model: nn.Module) -> Dict[str, tuple]:
    """{flax path below 'params': shape in the JAX layout} of every parameter
    of `model`: the template a partial load (`utils.torch_import`) checks
    against, without copying any parameter."""
    names, params = zip(*model.named_parameters())
    dummies = [np.broadcast_to(np.float32(0), p.shape) for p in params]
    return {k: a.shape for k, a in _jax_paths(model, names, dummies).items()}
