"""Staged FLAME landmark fitting: a Levenberg-Marquardt loop per stage.

The PyTorch port's own copy of the JAX package's `fitting/fit.py`. It
replaces the reference's two vendored fitting stages (third_party/MICA/
demo.py, identity from a photo, and third_party/metrical-tracker/
tracker.py, a ~1000-step Adam photometric and landmark fit) with a
landmark fit that needs nothing outside the repository: detected 2D
landmarks in, FLAME parameters and mesh out.

Parameters live in one flat vector, flattened in sorted key order
(`cam_r`, `cam_t`, `exp`, `pose`, `shape`: the order of JAX's
`ravel_pytree`). Each stage is a Levenberg-Marquardt loop: the full
Jacobian (`torch.func.jacfwd`; ~300 residuals x ~170 parameters), one
damped (P, P) normal-equation solve, and a branchless accept/reject that
adapts lambda. The parameters, lambda and the cost stay on the device and
are updated with `torch.where`, so an iteration never waits for the host;
the host reads the cost once a stage. Stage masks zero the Jacobian
columns of frozen parameters. Stages follow the tracker's curriculum:
rigid camera alignment, then expression and jaw, then everything, and an
optional silhouette stage when a subject matte is given.

`fit_two_photos` fits identity on the input photo, then the expression
photo with that shape frozen: the reference's tracker with MICA's identity
codes injected.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from morphablediffusion_torch.fitting.flame import (
    FlameModel,
    flame_forward,
    flame_landmarks,
    project_points,
)

KEYS = ("cam_r", "cam_t", "exp", "pose", "shape")  # the flat vector's order


@dataclasses.dataclass
class FitConfig:
    steps_per_stage: int = 40  # LM iterations per stage (each one solve)
    # regularizer weights (squared L2 on the codes, like the tracker's
    # priors); the data residuals are in reference pixels (see _residuals),
    # so with codes ~ N(0, 1) these bias the fit by well under a pixel
    # (w = sigma_noise^2 / sigma_prior^2, ~0.5 px detector noise)
    w_shape: float = 0.3
    w_exp: float = 0.3
    w_pose: float = 1e-3   # non-global joints (neck/jaw/eyes) stay small
    # the 17 jaw-contour points slide on the mesh: a lower weight than the
    # 51 inner points (68-point sets only)
    w_contour: float = 0.4
    # silhouette stage (only when fit_landmarks gets a subject mask): the
    # two residual blocks' weights (fitting/silhouette.py) and the rounds of
    # visibility refresh (rasterized on the host, held fixed in a stage)
    w_sil_inside: float = 0.05
    w_sil_cover: float = 0.2
    sil_rounds: int = 2
    sil_contour_n: int = 96
    # which parameters the silhouette stage moves: "rigid" (camera + global
    # rotation, the default) or "full"
    sil_trainable: str = "rigid"


def init_params(model: FlameModel, image_size: int) -> Dict[str, torch.Tensor]:
    J, dev = model.num_joints, model.device
    return {
        "shape": torch.zeros(model.n_shape, device=dev),
        "exp": torch.zeros(model.n_exp, device=dev),
        "pose": torch.zeros(J * 3, device=dev),
        "cam_r": torch.zeros(3, device=dev),
        # the head a few face-heights in front of the camera; the rigid
        # stage corrects it
        "cam_t": torch.tensor([0.0, 0.0, 1.0], device=dev),
    }


def ravel(params: Dict[str, torch.Tensor]):
    """(flat vector in KEYS order, unravel): JAX's `ravel_pytree` of the
    parameter dict, whose keys it sorts."""
    sizes = [params[k].numel() for k in KEYS]

    def unravel(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(KEYS, torch.split(flat, sizes)))

    return torch.cat([params[k].reshape(-1) for k in KEYS]), unravel


def _stage_masks(params, freeze_shape: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """Which entries train in each stage (1.0 = train).

    With ``freeze_shape`` the identity code trains in no stage (used by
    `fit_two_photos`, so the expression fit cannot drift the shape it was
    initialized with).
    """
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    def only(keys, extra=None):
        m = dict(zeros)
        for k in keys:
            m[k] = torch.ones_like(params[k])
        m.update(extra or {})
        return m

    # the global rotation lives in pose[0:3]
    global_rot = torch.zeros_like(params["pose"])
    global_rot[:3] = 1.0
    rigid = only(["cam_r", "cam_t"], extra={"pose": global_rot})
    expr = only(["exp", "cam_t"], extra={"pose": torch.ones_like(params["pose"])})
    full = {k: torch.ones_like(v) for k, v in params.items()}
    if freeze_shape:
        full["shape"] = torch.zeros_like(params["shape"])
    return {"rigid": rigid, "expression": expr, "full": full}


def _residuals(params, model: FlameModel, lmk2d: torch.Tensor, K: torch.Tensor,
               cfg: FitConfig, lmk_weight: torch.Tensor):
    """Weighted least-squares residual vector: landmark reprojection in
    reference pixels (the error scaled to a 300 px-focal camera, so the
    regularizer weights act at sub-pixel scale whatever the image size)
    followed by the code priors. cost = 0.5 * sum(residuals**2)."""
    verts = flame_forward(model, params["shape"], params["exp"], params["pose"])
    l3d = flame_landmarks(model, verts, params["pose"])
    uv = project_points(l3d, params["cam_r"], params["cam_t"], K)
    r_data = (uv - lmk2d) * (300.0 / K[0, 0]) * torch.sqrt(lmk_weight)[:, None]
    return torch.cat([
        r_data.reshape(-1),
        cfg.w_shape ** 0.5 * params["shape"],
        cfg.w_exp ** 0.5 * params["exp"],
        cfg.w_pose ** 0.5 * params["pose"][3:],
    ])


def _lm_stage_runner(res_fn, P: int):
    """One Levenberg-Marquardt stage: run(flat, mask_flat, steps) ->
    (flat_params, final_cost), both on the device.

    res_fn: flat (P,) params -> (R,) residual vector. Each iteration forms
    the full Jacobian (forward mode, with the residuals as its auxiliary
    output), solves the damped normal equations (`solve_ex`: no host check
    of the factorization), and accepts or rejects with `torch.where`;
    `mask_flat` zeroes the Jacobian columns and updates of frozen
    parameters. Nothing in an iteration waits for the host.
    """

    def with_aux(f):
        r = res_fn(f)
        return r, r

    jac = torch.func.jacfwd(with_aux, has_aux=True)

    def run(flat, mask_flat, steps: int):
        eye = torch.eye(P, dtype=flat.dtype, device=flat.device)
        r0 = res_fn(flat)
        cost = 0.5 * torch.sum(r0 * r0)
        lam = torch.full((), 1e-2, dtype=flat.dtype, device=flat.device)  # no host copy
        p = flat
        for _ in range(steps):
            J, r = jac(p)
            J = J * mask_flat[None, :]
            A = J.T @ J + lam * eye
            delta = -torch.linalg.solve_ex(A, J.T @ r)[0] * mask_flat
            p_new = p + delta
            r_new = res_fn(p_new)
            c_new = 0.5 * torch.sum(r_new * r_new)
            ok = c_new < cost
            p = torch.where(ok, p_new, p)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
            cost = torch.where(ok, c_new, cost)
        return p, cost

    return run


def canonicalize_global(model: FlameModel, params: Dict[str, np.ndarray]):
    """Fold the fitted global rotation into the camera (gauge fix).

    Landmarks observe only cam_R @ R_global, so the optimizer splits the
    head rotation between pose[:3] and cam_r; the pipeline's contract is a
    canonical mesh with the rigid transform in the camera. With G the
    global rotation about the root joint j0: cam_R' = cam_R @ G,
    cam_t' = cam_t + cam_R @ (I - G) @ j0, and pose[:3] = 0 reproduces the
    projections. The rotations are scipy's, in float64 on the host.
    """
    from scipy.spatial.transform import Rotation

    p = {k: np.asarray(v).copy() for k, v in params.items()}
    g = p["pose"][:3]
    if float(np.abs(g).max()) == 0.0:
        return p
    G = Rotation.from_rotvec(g).as_matrix()
    dev = model.device
    with torch.no_grad():
        betas = torch.cat([torch.as_tensor(p["shape"], device=dev),
                           torch.as_tensor(p["exp"], device=dev)])
        v_shaped = model.v_template + torch.einsum("vks,s->vk", model.shapedirs, betas)
        j0 = (model.j_regressor @ v_shaped).cpu().numpy()[0]
    Rc = Rotation.from_rotvec(np.asarray(p["cam_r"])).as_matrix()
    p["cam_r"] = Rotation.from_matrix(Rc @ G).as_rotvec().astype(np.float32)
    p["cam_t"] = (np.asarray(p["cam_t"]) + Rc @ (j0 - G @ j0)).astype(np.float32)
    p["pose"][:3] = 0.0
    return p


def fit_landmarks(
    model: FlameModel,
    lmk2d: np.ndarray,            # (L, 2) pixel coords, ibug-68 order when L=68
    K: np.ndarray,                # (3, 3) or (4, 4) intrinsics
    cfg: Optional[FitConfig] = None,
    init: Optional[Dict[str, object]] = None,
    image_size: int = 256,
    freeze_shape: bool = False,
    mask: Optional[np.ndarray] = None,  # (S, S) subject matte -> +silhouette
    lmk_conf: Optional[np.ndarray] = None,  # (L,) per-landmark confidence
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Fit FLAME parameters to one photo's 2D landmarks, on the model's
    device.

    Staged Levenberg-Marquardt (see the module docstring); the
    reprojection error is reported over the observed landmarks only, and
    is NaN (0/0) when none is observed, as in the JAX package.

    Returns (params, info): numpy parameters with the global rotation folded
    into the camera, and the per-stage final costs plus the mean pixel
    reprojection error.
    """
    cfg = cfg or FitConfig()
    dev = model.device
    K = torch.as_tensor(np.asarray(K, np.float32)[:3, :3], device=dev)
    lmk2d = torch.as_tensor(np.asarray(lmk2d, np.float32), device=dev)
    L = lmk2d.shape[0]
    weight = np.ones((L,), np.float32)
    if L == 68:  # contour-first ibug layout (flame_landmarks's output order)
        weight[:17] = cfg.w_contour
    if lmk_conf is not None:
        # detector confidence (0 = unobserved): the weights multiply the
        # squared residual, so confidences act as inverse noise variances
        weight = weight * np.asarray(lmk_conf, np.float32)
    observed = float(weight.max()) != 0
    weight = torch.as_tensor(weight, device=dev)

    params = {k: torch.as_tensor(v).to(dev, torch.float32)
              for k, v in (init or init_params(model, image_size)).items()}
    masks = _stage_masks(params, freeze_shape=freeze_shape)
    flat, unravel = ravel(params)
    P = flat.shape[0]

    run = _lm_stage_runner(
        lambda f: _residuals(unravel(f), model, lmk2d, K, cfg, weight), P)
    info = {}
    # with no observed landmark (a pure-silhouette fit) the landmark stages
    # would minimize the priors alone, shrinking the caller's initial codes
    # toward zero for no data reason; skip them
    for name in ("rigid", "expression", "full") if observed else ():
        flat, cost = run(flat, ravel(masks[name])[0], cfg.steps_per_stage)
        info[f"loss_{name}"] = float(cost)

    if mask is not None and (cfg.w_sil_inside > 0 or cfg.w_sil_cover > 0):
        flat, info["loss_silhouette"] = _silhouette_stage(
            model, flat, unravel, masks, mask, lmk2d, K, cfg, weight)

    params = unravel(flat)
    with torch.no_grad():
        verts = flame_forward(model, params["shape"], params["exp"], params["pose"])
        uv = project_points(flame_landmarks(model, verts, params["pose"]),
                            params["cam_r"], params["cam_t"], K)
        obs = (weight > 0).to(torch.float32)  # the error on observed landmarks only
        info["mean_px_err"] = float(
            torch.sum(torch.linalg.norm(uv - lmk2d, dim=-1) * obs) / torch.sum(obs))
    return canonicalize_global(
        model, {k: v.detach().cpu().numpy() for k, v in params.items()}), info


def _silhouette_stage(model, flat, unravel, masks, mask, lmk2d, K, cfg, weight):
    """The 4th stage: landmark + silhouette coupling (fitting/silhouette.py),
    `cfg.sil_rounds` rounds of host-side visibility and correspondences,
    each followed by an LM stage on the device. Returns (flat, cost)."""
    from morphablediffusion_torch.fitting import silhouette as sil

    dev = flat.device
    mask_np = np.asarray(mask).astype(bool)
    S = mask_np.shape  # (h, w): photos need not be square
    dt_out = torch.as_tensor(sil.mask_to_dt(mask_np), device=dev)
    contour_np = sil.mask_contour(mask_np, cfg.sil_contour_n)
    K_np = K.cpu().numpy()
    px_scale = float(300.0 / K_np[0, 0])
    sil_stage = "rigid" if cfg.sil_trainable == "rigid" else "full"
    mask_flat = ravel(masks[sil_stage])[0]

    def sil_res_fn(f, vis, deadband, corr):
        p = unravel(f)
        verts = flame_forward(model, p["shape"], p["exp"], p["pose"])
        uv = project_points(verts, p["cam_r"], p["cam_t"], K)
        r_in, r_cov = sil.silhouette_residuals(
            uv, vis, dt_out, *corr, px_scale, cfg.w_sil_inside, cfg.w_sil_cover,
            deadband_px=deadband)
        return torch.cat([_residuals(p, model, lmk2d, K, cfg, weight), r_in, r_cov])

    for _ in range(cfg.sil_rounds):
        p_np = {k: v.detach().cpu().numpy() for k, v in unravel(flat).items()}
        vis_np = sil.vertex_visibility(model, p_np, K_np, S)
        vpx = sil._verts_px(model, p_np, K_np)[:, :2]
        deadband = sil.vertex_spacing_px(vpx, vis_np)
        corr = sil.contour_correspondences(
            contour_np, sil.render_silhouette(model, p_np, K_np, S), vpx, vis_np,
            max_px=0.15 * min(S), target_mask=mask_np)
        corr = tuple(torch.as_tensor(c, device=dev) for c in corr)
        corr = (corr[0].to(torch.int64),) + corr[1:]
        run_sil = _lm_stage_runner(functools.partial(
            sil_res_fn, vis=torch.as_tensor(vis_np, device=dev), deadband=deadband,
            corr=corr), flat.shape[0])
        flat, cost = run_sil(flat, mask_flat, cfg.steps_per_stage)
    return flat, float(cost)


def fit_two_photos(
    model: FlameModel,
    lmk_input: np.ndarray,
    lmk_exp: np.ndarray,
    K: np.ndarray,
    cfg: Optional[FitConfig] = None,
    mask_input: Optional[np.ndarray] = None,  # subject mattes -> the silhouette
    mask_exp: Optional[np.ndarray] = None,    # stage per photo (see fit_landmarks)
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Identity from the input photo + expression/pose from the expression
    photo -> retargeted vertices (generate_face.sh stages 1-2: the
    reference's MICA identity codes injected into the tracker's fit).

    Sequential, because the expression photo may show a different person:
    fit the input photo for identity, then the expression photo with that
    shape frozen. The expression fit starts from `init_params(model, 256)`
    whatever the photo size, as in the JAX package. The returned mesh is
    canonical (`canonicalize_global`).
    """
    cfg = cfg or FitConfig()
    p_in, info_in = fit_landmarks(model, lmk_input, K, cfg, mask=mask_input)
    init = init_params(model, 256)
    init["shape"] = torch.as_tensor(p_in["shape"], device=model.device)
    p_exp, info_exp = fit_landmarks(
        model, lmk_exp, K, cfg, init=init, freeze_shape=True, mask=mask_exp)
    dev = model.device
    with torch.no_grad():
        verts = flame_forward(
            model,
            torch.as_tensor(p_in["shape"], device=dev),   # identity: input photo
            torch.as_tensor(p_exp["exp"], device=dev),    # expression/pose: expression photo
            torch.as_tensor(p_exp["pose"], device=dev),   # canonical (global folded out)
        )
    info = {f"input_{k}": v for k, v in info_in.items()}
    info.update({f"exp_{k}": v for k, v in info_exp.items()})
    return verts.cpu().numpy(), info
