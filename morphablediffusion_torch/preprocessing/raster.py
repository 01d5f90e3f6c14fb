"""Depth rasterization for preprocessing (mask and visibility rendering).

The PyTorch port's own copy of the JAX package's `preprocessing/raster.py`.
The reference renders with pyrender/EGL (`render_cvcam`,
preprocessing/facescape/renderer.py); here a cv-convention pinhole
projection in numpy feeds the repository's C++ z-buffer rasterizer,
`native/rasterizer.cpp`, on the host.

The port builds that source itself with `g++ -O3 -shared -fPIC` at first
use, into `build/native/` at the repository root, under a name that carries
a hash of the source and the flags (an edited source is rebuilt), and loads
it with `ctypes`. It never loads the prebuilt library committed beside the
source. There is no fallback: if the library cannot be built or loaded,
`rasterize_depth_px` raises. `rasterize_depth_numpy` is the plain version
of the same z-buffer, for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "rasterizer.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librasterizer_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `native/rasterizer.cpp` unless its library exists; raise if
    the compiler is missing or fails. Returns the library's path."""
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the rasterizer library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build writes the same bytes
    return lib


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.rasterize_depth.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rasterize_depth.restype = None
        _LIB = lib
    return _LIB


def rasterize_depth_px(
    verts_px: np.ndarray, tris: np.ndarray, h: int, w: int
) -> np.ndarray:
    """verts_px: (N, 3) [x_px, y_px, z_cam] float; tris: (M, 3) int.
    Returns the (h, w) float32 depth map, 0 = background."""
    verts_px = np.ascontiguousarray(verts_px, dtype=np.float32)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    if verts_px.ndim != 2 or verts_px.shape[1] != 3 or tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"verts_px {verts_px.shape} and tris {tris.shape} must be (N, 3)")
    lib = _load_lib()
    out = np.zeros((h, w), dtype=np.float32)
    lib.rasterize_depth(
        verts_px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(verts_px)),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(tris)),
        ctypes.c_int32(h), ctypes.c_int32(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def rasterize_depth_numpy(verts_px, tris, h, w) -> np.ndarray:
    """The plain version: a per-triangle bounding-box walk with a z-buffer
    in numpy, the same coverage rule and perspective-correct depth."""
    verts_px = np.asarray(verts_px, np.float32)
    tris = np.asarray(tris, np.int32)
    zbuf = np.full((h, w), np.inf, dtype=np.float32)
    v = verts_px[tris]  # (M, 3, 3)
    valid = np.all(v[..., 2] > 0, axis=1)
    for a, b, c in v[valid]:
        x0 = max(0, int(np.floor(min(a[0], b[0], c[0]))))
        x1 = min(w - 1, int(np.ceil(max(a[0], b[0], c[0]))))
        y0 = max(0, int(np.floor(min(a[1], b[1], c[1]))))
        y1 = min(h - 1, int(np.ceil(max(a[1], b[1], c[1]))))
        if x0 > x1 or y0 > y1:
            continue
        area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(area) < 1e-12:
            continue
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        px, py = np.meshgrid(xs, ys)
        w0 = ((b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])) / area
        w1 = ((c[0] - b[0]) * (py - b[1]) - (c[1] - b[1]) * (px - b[0])) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = w1 / a[2] + w2 / b[2] + w0 / c[2]
        with np.errstate(divide="ignore"):
            z = np.where(iz > 0, 1.0 / np.maximum(iz, 1e-30), np.inf)
        z = np.where(inside, z, np.inf).astype(np.float32)
        tile = zbuf[y0 : y1 + 1, x0 : x1 + 1]
        np.minimum(tile, z, out=tile)
    return np.where(np.isinf(zbuf), 0.0, zbuf).astype(np.float32)


def render_depth_cv(
    verts: np.ndarray, tris: np.ndarray, K: np.ndarray, Rt: np.ndarray,
    rend_size: Tuple[int, int],
) -> np.ndarray:
    """Depth map under a cv-convention camera (renderer.py render_cvcam
    contract): K (3,3), Rt (3,4) world->cam, rend_size (h, w)."""
    h, w = rend_size
    K = np.asarray(K, np.float64)
    Rt = np.asarray(Rt, np.float64)
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    z = cam[:, 2:3]
    uv = cam @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-12)
    verts_px = np.concatenate([uv, z], axis=-1)
    return rasterize_depth_px(verts_px, tris, h, w)
