"""Minimal mesh and pickle IO: the PyTorch port's own copy of the JAX
package's `utils/mesh_io.py`.

Exactly what the pipelines need: OBJ vertex lists (the FaceScape FLAME
tracking meshes, `<flame_assets_dir>/<subject>/<expr>/mesh.obj`), PLY meshes
(the fitted mesh that `generate_face.sh` hands to the sampler, ASCII or
binary little-endian), vertex arrays (.npy / .txt), and pickled camera
metadata (the real camera trajectory of `generate_face`).
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path

import numpy as np

# PLY property types -> (struct code, bytes)
_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
    "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2), "ushort": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
}


def read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_obj_vertices(path) -> np.ndarray:
    """(N, 3) float64 xyz of the `v` lines of an OBJ file."""
    verts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, dtype=np.float64)


def _ply_header(path):
    """(format, elements [{name, count, props}], body bytes) of a PLY file."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    fmt, elements = "ascii", []
    for line in header.splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append({"name": t[1], "count": int(t[2]), "props": []})
        elif t[0] == "property" and elements:
            elements[-1]["props"].append(t[1:])
    return fmt, elements, data[header_end:]


def load_ply_vertices(path) -> np.ndarray:
    """ASCII or binary_little_endian PLY; returns (N, 3) float64 xyz."""
    fmt, elements, body = _ply_header(path)
    vertex = next((el for el in elements if el["name"] == "vertex"), None)
    n_verts = vertex["count"] if vertex else 0
    props = [(p[0], p[-1]) for p in vertex["props"]] if vertex else []
    idx = {name: i for i, (_, name) in enumerate(props)}
    if fmt == "ascii":
        rows = []
        for line in body.decode("ascii").splitlines()[:n_verts]:
            vals = line.split()
            rows.append([float(vals[idx["x"]]), float(vals[idx["y"]]), float(vals[idx["z"]])])
        return np.asarray(rows, dtype=np.float64)
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    fmt_str = "<" + "".join(_PLY_TYPES[t][0] for t, _ in props)
    stride = struct.calcsize(fmt_str)
    out = np.empty((n_verts, 3), dtype=np.float64)
    for i in range(n_verts):
        vals = struct.unpack_from(fmt_str, body, i * stride)
        out[i] = (vals[idx["x"]], vals[idx["y"]], vals[idx["z"]])
    return out


def load_obj(path):
    """(verts (N,3) float64, faces (M,3) int32); polygons are fan-triangulated."""
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def load_ply(path):
    """(verts (N,3) float64, faces (M,3) int32) from ASCII or binary-LE PLY."""
    fmt, elements, body = _ply_header(path)
    verts, faces = [], []
    if fmt == "ascii":
        lines = body.decode("ascii").splitlines()
        pos = 0
        for el in elements:
            if el["name"] == "vertex":
                names = [p[-1] for p in el["props"]]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                for line in lines[pos : pos + el["count"]]:
                    v = line.split()
                    verts.append([float(v[xi]), float(v[yi]), float(v[zi])])
            elif el["name"] == "face":
                for line in lines[pos : pos + el["count"]]:
                    v = [int(x) for x in line.split()]
                    idx = v[1 : 1 + v[0]]
                    for i in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
            pos += el["count"]
    elif fmt == "binary_little_endian":
        off = 0
        for el in elements:
            if el["name"] == "vertex":
                fmt_str = "<" + "".join(_PLY_TYPES[p[0]][0] for p in el["props"])
                stride = struct.calcsize(fmt_str)
                names = [p[-1] for p in el["props"]]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                for i in range(el["count"]):
                    vals = struct.unpack_from(fmt_str, body, off + i * stride)
                    verts.append([vals[xi], vals[yi], vals[zi]])
                off += el["count"] * stride
            elif el["name"] == "face":
                # list property: <count_type> <index_type>
                cs, is_ = _PLY_TYPES[el["props"][0][1]], _PLY_TYPES[el["props"][0][2]]
                for _ in range(el["count"]):
                    (n,) = struct.unpack_from("<" + cs[0], body, off)
                    off += cs[1]
                    idx = struct.unpack_from("<" + is_[0] * n, body, off)
                    off += is_[1] * n
                    for i in range(1, n - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def load_mesh(path):
    """(verts, faces) for OBJ/PLY."""
    path = Path(path)
    if path.suffix.lower() == ".obj":
        return load_obj(path)
    if path.suffix.lower() == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_mesh_vertices(path) -> np.ndarray:
    """Vertices of an OBJ or PLY mesh, or of a (N, 3) .npy / .txt array."""
    path = Path(path)
    if path.suffix.lower() == ".obj":
        return load_obj_vertices(path)
    if path.suffix.lower() == ".ply":
        return load_ply_vertices(path)
    if path.suffix.lower() in (".npy", ".txt"):
        try:
            return np.load(path)
        except (ValueError, pickle.UnpicklingError):
            return np.loadtxt(path)
    raise ValueError(f"unsupported mesh format: {path}")


def save_ply(path, verts, faces=None):
    """ASCII PLY writer (the fitted-mesh file that `generate_face.sh` passes
    from the fitting stage to the sampler)."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = None if faces is None else np.asarray(faces, dtype=np.int32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
