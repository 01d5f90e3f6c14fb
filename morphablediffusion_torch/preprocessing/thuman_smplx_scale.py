"""Per-scan SMPL-X normalization stats for THuman 2.1.

The PyTorch port's own copy of the JAX package's
`preprocessing/thuman_smplx_scale.py`.

Contract of the reference's get_smplx_scale.py: for each scan uid, read the
fitted smplx parameter pickle to get its global scale, store
scale = 0.6 / smplx_scale plus the centroid of the SMPL-X mesh vertices as
`<out>/<uid>.npy` = [scale, cx, cy, cz]. The blender render step and the
THuman dataset loader both consume this file (thuman.py:96-103).

Usage:
    python -m morphablediffusion_torch.preprocessing.thuman_smplx_scale \
        --smplx_dir THuman2.1/smplx --out_dir THuman2.1/smplx_stats
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from morphablediffusion_torch.utils.mesh_io import load_obj_vertices


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--smplx_dir", type=Path, required=True,
                   help="dir with <uid>/smplx_param.pkl + <uid>/mesh_smplx.obj")
    p.add_argument("--out_dir", type=Path, required=True)
    args = p.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    for uid_dir in sorted(d for d in args.smplx_dir.iterdir() if d.is_dir()):
        uid = uid_dir.name
        with open(uid_dir / "smplx_param.pkl", "rb") as f:
            param = pickle.load(f)
        smplx_scale = float(np.asarray(param["scale"]).reshape(-1)[0])
        scale = 0.6 / smplx_scale
        verts = load_obj_vertices(uid_dir / "mesh_smplx.obj")
        center = verts.mean(axis=0)
        np.save(
            args.out_dir / f"{uid}.npy",
            np.asarray([scale, *center], dtype=np.float32),
        )
        print(uid, scale)


if __name__ == "__main__":
    main()
