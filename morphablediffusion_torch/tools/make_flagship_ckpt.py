"""Build a flagship-width, reference-named torch .ckpt for real-weights runs.

The port's counterpart of the repository's `tools/make_flagship_ckpt.py`.
The published morphable-diffusion checkpoints (download_data.sh) cannot be
fetched everywhere, so the real-weights runs (the import path, numerics
that depend on the values, `tools/int8_trajectory.py`) take a checkpoint
synthesized at the exact flagship width (`Config()`, 16 views, 256^2) with
realistic magnitudes: every leaf follows its initializer family (kernels
N(0, 1/fan_in) with fan_in from the JAX shape, unit norm scales and BN
variances, zero biases and BN means, other 1-D leaves N(0, 0.02^2)), drawn
from one numpy generator in the JAX tree's order (its flax paths sorted
part by part), so that for a seed the values are the JAX tool's. They are
exported through `utils/torch_import.py::export_torch_checkpoint`, the
importer's exact inverse, into the reference's state_dict naming; importing
the file back exercises every mapped path a published checkpoint would.

    python -m morphablediffusion_torch.tools.make_flagship_ckpt --out flagship.ckpt \
        [--fine] [--seed 0] [--device cpu]

The file holds fp32 tensors, as the JAX tool's; the model is built on
`--device` (default the CUDA card, where the 1.3 B fp32 parameters fit).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

def leaf_init(name: str, shape, rng) -> np.ndarray:
    """One leaf by its flax name and JAX shape (the JAX tool's rule)."""
    if name in ("scale", "var"):
        return np.ones(shape, np.float32)
    if name in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        std = (1.0 / max(fan_in, 1)) ** 0.5
        return rng.normal(0.0, std, shape).astype(np.float32)
    return rng.normal(0.0, 0.02, shape).astype(np.float32)


def flagship_tree(shapes: Dict[str, tuple], seed: int) -> Dict[str, np.ndarray]:
    """{flax path: JAX shape} -> {flax path: leaf}, drawn in the JAX tree's
    flatten order (dict keys sorted at every level)."""
    rng = np.random.default_rng(seed)
    return {p: leaf_init(p.rsplit("/", 1)[-1], shapes[p], rng)
            for p in sorted(shapes, key=lambda p: p.split("/"))}


@torch.no_grad()
def flagship_model(cfg, seed: int, device):
    """The MorphableDiffusion of `cfg` on `device` holding `flagship_tree`'s
    values (fp32). Returns (model, number of parameters)."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.weights import from_jax_params, jax_shapes

    model = MorphableDiffusion(cfg.model, device=device)
    flat = flagship_tree(jax_shapes(model), seed)
    n = sum(v.size for v in flat.values())
    model.load_state_dict(from_jax_params(flat, device=device), strict=True)
    return model, n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fine", action="store_true",
                    help="include spconv (xyzc_net) tensors for the "
                         "fine-grid conditioner")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    args = ap.parse_args(argv)

    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.utils.torch_import import export_torch_checkpoint

    cfg = Config()
    if args.fine:
        cfg.model.mesh_voxel_mode = "fine"
    model, n = flagship_model(cfg, args.seed, resolve_device(args.device))
    count = export_torch_checkpoint(model, args.out)
    result = {"out": args.out, "tensors": count, "params_m": round(n / 1e6, 1),
              "fine": args.fine}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
