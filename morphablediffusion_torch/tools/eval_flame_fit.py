"""Quantify the port's FLAME landmark fitter on known-parameter ground truth.

The port's counterpart of the repository's `tools/eval_flame_fit.py`, with
the port's `fitting/` on the card. Protocol, per trial:

  1. sample ground-truth codes (shape ~ N(0,1), exp ~ N(0,1), small global,
     neck and jaw pose) for a FLAME2020-format model (the port's synthetic
     FLAME assets, the same loader as the real download);
  2. render the 68 ibug landmarks (17 yaw-bucketed contour + 51 static)
     with a known perspective camera, adding pixel noise at the level of a
     real detector's jitter (`--noise_px`);
  3. fit from the 2D landmarks alone (fit_landmarks, staged curriculum);
  4. report the mean 2D reprojection error, the 3D vertex RMS between the
     fitted and ground-truth meshes in camera space, absolute and relative
     to the head radius, and the shape/exp code cosines (codes are
     identifiable only up to the regularizer's null space; vertex RMS is
     the real metric); with --silhouette also the fit with the silhouette
     stage on the ground truth's rasterized mask.

Retarget trials fit two "photos" of one identity with different
expressions (fit_two_photos) and measure the recombined mesh against the
ground truth (identity, second expression). The JSON has the JAX tool's
keys (config, per_noise, retarget).

    python -m morphablediffusion_torch.tools.eval_flame_fit [--out flame_fit_eval.json]
        [--assets DIR] [--vertices 1024] [--trials 6] [--noise_px 0 1] [--silhouette]
        [--device cpu]

Without --assets the port's synthetic FLAME tool writes assets of
`--vertices` vertices and twice as many faces into a temporary directory.
`--out` defaults to the working directory.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def head_radius(verts: np.ndarray) -> float:
    c = verts.mean(axis=0)
    return float(np.linalg.norm(verts - c, axis=1).mean())


def _to_cam(v, r, t):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(np.asarray(r)).as_matrix()
    return v @ R.T + np.asarray(t)


def evaluate(model, args) -> dict:
    """The trials of the module docstring on `model` (a FlameModel on its
    device); `args` carries the flags."""
    from morphablediffusion_torch.fitting.fit import FitConfig, fit_landmarks, fit_two_photos
    from morphablediffusion_torch.fitting.flame import (flame_forward, flame_landmarks,
                                                        project_points)

    dev = model.device
    S = args.image_size
    K = np.array([[1.2 * S, 0, S / 2], [0, 1.2 * S, S / 2], [0, 0, 1]], np.float32)
    cam_r = np.zeros(3, np.float32)
    cam_t = np.array([0.0, 0.0, 0.6], np.float32)
    rng = np.random.default_rng(args.seed)
    cfg = FitConfig(steps_per_stage=args.steps)
    tt = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def sample_gt():
        shape = rng.normal(size=model.n_shape).astype(np.float32)
        exp = rng.normal(size=model.n_exp).astype(np.float32)
        pose = np.zeros(model.num_joints * 3, np.float32)
        pose[:3] = rng.normal(scale=0.15, size=3)   # global
        pose[3:6] = rng.normal(scale=0.08, size=3)  # neck
        pose[6:9] = rng.uniform(0, 0.2, 3) * [1, 0, 0]  # jaw: opening only
        return shape, exp, pose

    def verts(shape, exp, pose):
        with torch.no_grad():
            return flame_forward(model, tt(shape), tt(exp), tt(pose)).cpu().numpy()

    def render(shape, exp, pose):
        with torch.no_grad():
            v = flame_forward(model, tt(shape), tt(exp), tt(pose))
            l2d = project_points(flame_landmarks(model, v, tt(pose)), tt(cam_r), tt(cam_t),
                                 tt(K))
        return v.cpu().numpy(), l2d.cpu().numpy()

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))

    results = {"config": dict(vars(args), n_landmarks=17 + 51), "per_noise": {},
               "retarget": []}
    for noise in args.noise_px:
        rows = []
        for trial in range(args.trials):
            shape, exp, pose = sample_gt()
            v_gt, l2d = render(shape, exp, pose)
            radius = head_radius(v_gt)
            l2d_obs = l2d + rng.normal(scale=noise, size=l2d.shape)
            t0 = time.time()
            params, info = fit_landmarks(model, l2d_obs, K, cfg)
            fit_s = time.time() - t0
            params_sil = None
            if args.silhouette:
                from morphablediffusion_torch.fitting.silhouette import render_silhouette

                gt_mask = render_silhouette(
                    model, {"shape": shape, "exp": exp, "pose": pose, "cam_r": cam_r,
                            "cam_t": cam_t}, K, S)
                params_sil, info_sil = fit_landmarks(model, l2d_obs, K, cfg, mask=gt_mask,
                                                     image_size=S)
            # compare in CAMERA space: a landmark-only fit determines the
            # mesh up to the camera pose it jointly optimizes
            v_gt_cam = _to_cam(v_gt, cam_r, cam_t)
            v_fit_cam = _to_cam(verts(params["shape"], params["exp"], params["pose"]),
                                params["cam_r"], params["cam_t"])
            rms = float(np.sqrt(np.mean(np.sum((v_fit_cam - v_gt_cam) ** 2, axis=1))))
            rows.append({
                "px_err": info["mean_px_err"],
                "vertex_rms": rms,
                "vertex_rms_rel": rms / radius,
                "shape_cos": cos(params["shape"], shape),
                "exp_cos": cos(params["exp"], exp),
                "fit_seconds": fit_s,
            })
            if params_sil is not None:
                v_sil_cam = _to_cam(
                    verts(params_sil["shape"], params_sil["exp"], params_sil["pose"]),
                    params_sil["cam_r"], params_sil["cam_t"])
                rms_sil = float(np.sqrt(np.mean(np.sum((v_sil_cam - v_gt_cam) ** 2, axis=1))))
                rows[-1]["vertex_rms_sil"] = rms_sil
                rows[-1]["vertex_rms_sil_rel"] = rms_sil / radius
                rows[-1]["sil_px_err"] = info_sil["mean_px_err"]
            r = rows[-1]
            print(f"noise {noise}px trial {trial}: px {r['px_err']:.3f} "
                  f"vRMS {rms:.5f} ({100 * r['vertex_rms_rel']:.2f}% of head radius) "
                  f"shape_cos {r['shape_cos']:.3f} exp_cos {r['exp_cos']:.3f} [{fit_s:.1f}s]"
                  + (f" | +sil vRMS {r['vertex_rms_sil']:.5f} "
                     f"({100 * r['vertex_rms_sil_rel']:.2f}%)" if params_sil is not None
                     else ""), flush=True)
        agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        agg["trials"] = rows
        results["per_noise"][str(noise)] = agg

    # two-photo retarget: identity A with exp e1 (input) + exp e2 (target)
    for trial in range(max(2, args.trials // 2)):
        shape, exp1, pose1 = sample_gt()
        exp2 = rng.normal(size=model.n_exp).astype(np.float32)
        pose2 = pose1.copy()
        pose2[6:9] = rng.uniform(0, 0.25, 3) * [1, 0, 0]
        v_target, _ = render(shape, exp2, pose2)
        _, l_in = render(shape, exp1, pose1)
        _, l_exp = render(shape, exp2, pose2)
        v, info = fit_two_photos(model, l_in, l_exp, K, cfg)
        # the retargeted mesh is canonical with the pose fitted: align by
        # centroid only
        d = (v - v.mean(0)) - (v_target - v_target.mean(0))
        rms = float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
        rel = rms / head_radius(v_target)
        results["retarget"].append({
            "vertex_rms": rms, "vertex_rms_rel": rel,
            "input_px_err": info["input_mean_px_err"],
            "exp_px_err": info["exp_mean_px_err"],
        })
        print(f"retarget trial {trial}: vRMS {rms:.5f} ({100 * rel:.2f}% of head radius)",
              flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="flame_fit_eval.json")
    ap.add_argument("--assets", default="",
                    help="FLAME assets dir (generic_model.pkl + landmark_embedding.npy); "
                         "synthetic assets in a temporary directory when empty")
    ap.add_argument("--vertices", type=int, default=1024)
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--noise_px", type=float, nargs="*", default=[0.0, 1.0])
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--silhouette", action="store_true",
                    help="also fit WITH the silhouette stage (GT mask rendered by the "
                         "native rasterizer) and record the vertex-RMS delta")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    args = ap.parse_args(argv)

    from morphablediffusion_torch.fitting.flame import load_model
    from morphablediffusion_torch.tools import make_synthetic_flame
    from morphablediffusion_torch.tools.common import device_line
    from morphablediffusion_torch.utils import resolve_device

    device = resolve_device(args.device)
    flags = {k: v for k, v in vars(args).items() if k != "device"}  # the JAX tool's config
    with tempfile.TemporaryDirectory(prefix="flame_synth_") as tmp:
        assets = Path(args.assets or tmp)
        if not args.assets:
            make_synthetic_flame.main(["--out", str(assets), "--vertices", str(args.vertices),
                                       "--faces", str(2 * args.vertices)])
        model = load_model(str(assets / "generic_model.pkl"),
                           str(assets / "landmark_embedding.npy"), device=device)
    results = evaluate(model, argparse.Namespace(**flags))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"-> {out} ({device_line(device)})")
    return results


if __name__ == "__main__":
    main()
