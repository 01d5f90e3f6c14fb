"""FLAME 2020 morphable head model as plain PyTorch functions.

The PyTorch port's own copy of the JAX package's `fitting/flame.py`: the
in-tree replacement for the mesh-fitting stack the reference vendors
(third_party/MICA/models/flame.py, third_party/metrical-tracker/flame/
FLAME.py + flame/lbs.py). Shape and expression blendshapes, pose-corrective
blendshapes, joint regression, linear blend skinning and the barycentric
landmark embedding are functions of a `FlameModel` whose arrays live as
tensors on one device. Every function is written so that
`torch.func.jacfwd` can differentiate it: no host copy, no `.item()` and no
branch on a tensor's value (the kinematic chain's `parents` is a Python
tuple, and the jaw-contour bucket is an index computed from the primal).

Data: the user-downloaded FLAME2020 `generic_model.pkl` and
`landmark_embedding.npy`, or the port's synthetic assets
(`tools/make_synthetic_flame.py`). `random_model` draws a small model for
tests in the JAX package's order, and `model_from_jax` carries a JAX
`FlameModel`'s arrays across.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import numpy as np
import torch

from morphablediffusion_torch.utils import resolve_device

_TENSORS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
            "lmk_faces", "lmk_bary", "dyn_lmk_faces", "dyn_lmk_bary")


@dataclasses.dataclass(frozen=True)
class FlameModel:
    """Constants of the morphable model (tensors on one device; J = #joints)."""

    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_shape + n_exp)
    posedirs: torch.Tensor      # ((J-1)*9, V*3) pose-corrective basis
    j_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: tuple              # (J,) host ints, parents[0] = -1 encoded as 0
    faces: torch.Tensor         # (F, 3) int64
    # static landmark embedding (the 17 jaw-contour landmarks are
    # view-dependent; see the dynamic tables below)
    lmk_faces: torch.Tensor     # (L, 3) vertex ids of the landmark triangles
    lmk_bary: torch.Tensor      # (L, 3)
    # dynamic contour tables indexed by head yaw (79 buckets x 17 landmarks);
    # placeholders of one row when the embedding file lacks them
    dyn_lmk_faces: torch.Tensor  # (79, 17, 3)
    dyn_lmk_bary: torch.Tensor   # (79, 17, 3)
    n_shape: int = 100
    n_exp: int = 50

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def has_dynamic_contour(self) -> bool:
        return self.dyn_lmk_faces.shape[0] > 1

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "FlameModel":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _TENSORS})


def _build(arrays: dict, parents, n_shape: int, n_exp: int, device) -> FlameModel:
    """A FlameModel from numpy arrays: floats as fp32, indices as int64."""
    device = resolve_device(device)
    t = {}
    for k in _TENSORS:
        a = np.asarray(arrays[k])
        dtype = torch.int64 if k in ("faces", "lmk_faces", "dyn_lmk_faces") else torch.float32
        t[k] = torch.tensor(a, dtype=dtype, device=device)
    return FlameModel(parents=tuple(int(p) for p in np.asarray(parents).reshape(-1)),
                      n_shape=int(n_shape), n_exp=int(n_exp), **t)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    R = I + a K + b K^2 with K = skew(rvec) (unnormalized), a = sin(t)/t,
    b = (1 - cos t)/t^2; the t -> 0 limit is taken by its Taylor series
    under `torch.where`, so derivatives are finite at exactly zero.
    """
    sq = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    t = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(t) / t)[..., None]
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(t)) / safe_sq)[..., None]
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        *rvec.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a * K + b * (K @ K)


def flame_forward(model: FlameModel, shape: torch.Tensor, exp: torch.Tensor,
                  pose: torch.Tensor) -> torch.Tensor:
    """FLAME parameters -> posed vertices (V, 3) in model space.

    shape (n_shape,), exp (n_exp,), pose (J*3,) axis-angle (global, neck,
    jaw, eyes). Blendshapes, joint regression, the kinematic chain and LBS,
    as metrical-tracker's flame/lbs.py.
    """
    J = model.num_joints
    betas = torch.cat([shape, exp])
    v_shaped = model.v_template + torch.einsum("vks,s->vk", model.shapedirs, betas)
    joints = model.j_regressor @ v_shaped  # (J, 3)

    rots = rodrigues(pose.reshape(J, 3))  # (J, 3, 3)
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feature = (rots[1:] - eye).reshape(-1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(-1, 3)

    # kinematic chain over the host tuple `parents` (5 joints: unrolled; an
    # index tensor made from it would be copied to the device every call)
    world_R = [rots[0]]
    world_t = [joints[0]]
    for j in range(1, J):
        p = model.parents[j]
        world_R.append(world_R[p] @ rots[j])
        world_t.append(world_R[p] @ (joints[j] - joints[p]) + world_t[p])
    world_R = torch.stack(world_R)  # (J, 3, 3)
    world_t = torch.stack(world_t)  # (J, 3)

    # skinning transform relative to the rest pose: x -> R x + (t - R j)
    skin_t = world_t - torch.einsum("jab,jb->ja", world_R, joints)
    W = model.lbs_weights  # (V, J)
    R_v = torch.einsum("vj,jab->vab", W, world_R)
    t_v = W @ skin_t
    return torch.einsum("vab,vb->va", R_v, v_posed) + t_v


def _dyn_contour_index(pose: torch.Tensor) -> torch.Tensor:
    """Head-yaw bucket (0..78) selecting the jaw-contour embedding row, as a
    0-d int64 tensor.

    Buckets 0..39 cover yaw 0..39 deg, 40..78 cover -1..-39 deg (the
    published table's layout). The head rotation is the composed neck chain
    (global @ neck) and the angle atan2(+R[2,0], sy) in degrees, as
    metrical-tracker flame/lbs.py:58-122. The bucket is piecewise constant:
    an integer index from the value, with zero derivative, so under
    `torch.func.jacfwd` it comes from the primal alone.
    """
    R = rodrigues(pose[:3]) @ rodrigues(pose[3:6])
    yaw = torch.rad2deg(torch.atan2(R[2, 0], torch.hypot(R[0, 0], R[1, 0])))
    y = torch.clamp(torch.round(yaw), -39, 39).to(torch.int64)
    return torch.where(y >= 0, y, 39 - y)


def flame_landmarks(model: FlameModel, verts: torch.Tensor,
                    pose: torch.Tensor) -> torch.Tensor:
    """Posed vertices -> 3D landmarks via the barycentric embedding.

    Returns (17 + L_static, 3) = the ibug-68 layout (contour first) when the
    dynamic tables are present, else the static set alone.
    """
    static = torch.einsum("lk,lkc->lc", model.lmk_bary, verts[model.lmk_faces])
    if not model.has_dynamic_contour:
        return static
    idx = _dyn_contour_index(pose)[None]  # a 1-d index: a 0-d one is read on the host
    faces = model.dyn_lmk_faces[idx][0]  # (17, 3)
    bary = model.dyn_lmk_bary[idx][0]    # (17, 3)
    contour = torch.einsum("lk,lkc->lc", bary, verts[faces])
    return torch.cat([contour, static], dim=0)


def project_points(pts: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """Perspective projection of (N, 3) world points to (N, 2) pixels."""
    cam = pts @ rodrigues(rvec).T + tvec
    z = torch.clamp_min(cam[:, 2:3], 1e-6)
    uv = cam[:, :2] / z
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


# --------------------------------------------------------------------- #
# loading


def load_model(pkl_path: str, lmk_path: Optional[str] = None, n_shape: int = 100,
               n_exp: int = 50, device=None) -> FlameModel:
    """Load FLAME2020 `generic_model.pkl` (+ `landmark_embedding.npy`) onto
    `device` (default: the CUDA card, raising without one).

    The pkl stores shapedirs as (V, 3, 400) with columns [0:300] shape and
    [300:400] expression; the leading n_shape and n_exp of each are kept,
    as the reference tracker slices them.
    """
    device = resolve_device(device)
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def arr(x, dtype=np.float32):
        if hasattr(x, "todense"):
            x = x.todense()
        return np.asarray(x, dtype=dtype)

    shapedirs = arr(data["shapedirs"])
    shapedirs = np.concatenate(
        [shapedirs[:, :, :n_shape], shapedirs[:, :, 300 : 300 + n_exp]], axis=2)
    posedirs = arr(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # ((J-1)*9, V*3)
    parents = arr(data["kintree_table"], np.int64)[0]
    parents[0] = 0  # the root's parent is unused; 0 keeps gathers in bounds
    faces = arr(data["f"], np.int32)

    if lmk_path is not None:
        emb = np.load(lmk_path, allow_pickle=True, encoding="latin1")[()]
        lmk_faces = faces[arr(emb["static_lmk_faces_idx"], np.int32)]
        lmk_bary = arr(emb["static_lmk_bary_coords"])
        dyn_faces = faces[arr(emb["dynamic_lmk_faces_idx"], np.int32)]
        dyn_bary = arr(emb["dynamic_lmk_bary_coords"])
    else:
        lmk_faces = faces[:1]
        lmk_bary = np.full((1, 3), 1.0 / 3, np.float32)
        dyn_faces = np.zeros((1, 17, 3), np.int32)
        dyn_bary = np.zeros((1, 17, 3), np.float32)

    return _build(dict(
        v_template=arr(data["v_template"]), shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=arr(data["J_regressor"]), lbs_weights=arr(data["weights"]),
        faces=faces, lmk_faces=lmk_faces, lmk_bary=lmk_bary, dyn_lmk_faces=dyn_faces,
        dyn_lmk_bary=dyn_bary), parents, n_shape, n_exp, device)


def random_model(rng: np.random.Generator, n_verts: int = 128, n_shape: int = 8,
                 n_exp: int = 4, n_landmarks: int = 17, device=None) -> FlameModel:
    """Small synthetic model with FLAME's structure, for tests (no licensed
    data): a noisy sphere template, random smooth blendshape bases, a
    5-joint chain with distance-based skinning weights. Draws from `rng` in
    the JAX package's order, so one seed gives one model in both."""
    J = 5
    u = rng.normal(size=(n_verts, 3))
    v_template = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    v_template *= 0.1
    shapedirs = rng.normal(size=(n_verts, 3, n_shape + n_exp)).astype(np.float32)
    shapedirs *= 0.01
    posedirs = (rng.normal(size=((J - 1) * 9, n_verts * 3)) * 0.001).astype(np.float32)
    jr = np.abs(rng.normal(size=(J, n_verts))).astype(np.float32)
    jr /= jr.sum(axis=1, keepdims=True)
    joints = jr @ v_template
    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    w = np.exp(-d / 0.05).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    parents = np.array([0, 0, 1, 1, 1], np.int32)
    n_faces = max(n_landmarks, 4)
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    bary = rng.uniform(0.1, 1.0, size=(n_landmarks, 3)).astype(np.float32)
    bary /= bary.sum(axis=1, keepdims=True)
    return _build(dict(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs, j_regressor=jr,
        lbs_weights=w, faces=faces, lmk_faces=faces[:n_landmarks], lmk_bary=bary,
        dyn_lmk_faces=np.zeros((1, 17, 3), np.int32),
        dyn_lmk_bary=np.zeros((1, 17, 3), np.float32)), parents, n_shape, n_exp, device)


def model_from_jax(jax_model, device=None) -> FlameModel:
    """The weights carried across: a JAX `FlameModel` (its arrays read as
    numpy) -> the port's FlameModel on `device`."""
    arrays = {k: np.asarray(getattr(jax_model, k)) for k in _TENSORS}
    return _build(arrays, np.asarray(jax_model.parents), jax_model.n_shape,
                  jax_model.n_exp, device)

