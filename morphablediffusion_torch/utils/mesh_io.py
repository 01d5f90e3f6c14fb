"""Mesh vertex loading: the PyTorch port's own copy of what it needs from the
JAX package's `utils/mesh_io.py`, the vertex list of an OBJ file (the
FaceScape FLAME tracking meshes, `<flame_assets_dir>/<subject>/<expr>/mesh.obj`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_obj_vertices(path) -> np.ndarray:
    """(N, 3) float64 xyz of the `v` lines of an OBJ file."""
    verts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, dtype=np.float64)


def load_mesh_vertices(path) -> np.ndarray:
    """Vertices of a mesh file; the port reads OBJ only (the JAX package's
    PLY and array readers serve datasets the port does not load yet)."""
    path = Path(path)
    if path.suffix.lower() != ".obj":
        raise ValueError(f"unsupported mesh format: {path} (the port reads .obj)")
    return load_obj_vertices(path)
