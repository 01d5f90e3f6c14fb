"""In-tree FLAME mesh fitting CLI: generate_face.sh stages 1 and 2 with no
external checkouts, on the PyTorch port.

The port's counterpart of the JAX package's `apps/fit_face.py`, with every
flag it has plus `--device`. The reference runs the vendored MICA
(`third_party/MICA/demo.py`, identity codes from the input photo) and
metrical-tracker (`tracker.py`, the FLAME expression/pose fit to the
expression photo) to produce `mesh/00001.ply` for generate_face.py; this
CLI produces the same file from the same two photos:

  landmarks   - a precomputed .npy/.json (--input_landmarks/--exp_landmarks),
                the optional `face_alignment` package if it imports, or the
                port's 68-landmark net (eval/keypoint_net.py) from its own
                `.pt` file or the JAX package's flax-msgpack one
                (--kpt_weights; the shipped net is
                `artifacts/landmark_net_synth.msgpack`, trained at 128^2).
  fitting     - fitting/fit.py's staged Levenberg-Marquardt fit (identity
                from the input photo, expression/pose from the expression
                photo), on the device.
  FLAME data  - the user-downloaded FLAME2020 pkl + landmark embedding
                (download_data.sh), or the port's synthetic assets
                (`python -m morphablediffusion_torch.tools.make_synthetic_flame`).

The landmark net and every fitting tensor run on the CUDA card (it raises
without one unless `--device cpu`); the matting, distance transforms,
contour correspondences and the rasterizer stay on the host. TF32 is left
as PyTorch sets it: off for matmuls (the normal equations need fp32), on
for cuDNN convolutions (the landmark net).

Usage:
  python -m morphablediffusion_torch.apps.fit_face \\
      --input_img demo/input.png --exp_img demo/exp.jpg \\
      --flame assets/FLAME2020/generic_model.pkl \\
      --lmk_embedding assets/landmark_embedding.npy \\
      --out output/fitted_mesh.ply [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_image(path: str):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _detect(img: np.ndarray, precomputed: str, kpt_weights: str,
            kpt_size: int = 128, device="cpu") -> np.ndarray:
    """(H, W, 3) [0,1] -> (68, 2) pixel coords, trying backends in order:
    precomputed file, face_alignment (if installed), the landmark net on
    `device`."""
    if precomputed:
        p = Path(precomputed)
        if p.suffix == ".json":
            data = json.loads(p.read_text())
            arr = np.asarray(next(iter(data.values())) if isinstance(data, dict)
                             else data, np.float32)
        else:
            arr = np.load(p).astype(np.float32)
        return arr.reshape(68, 2)
    try:  # optional external detector, if the host has it
        import face_alignment  # type: ignore

        fa = face_alignment.FaceAlignment(
            face_alignment.LandmarksType.TWO_D, device="cpu")
        preds = fa.get_landmarks((img * 255).astype(np.uint8))
        if preds:
            return np.asarray(preds[0][:, :2], np.float32)
    except ImportError:
        pass
    if not kpt_weights:
        raise SystemExit(
            "no landmark source: pass --input_landmarks/--exp_landmarks, "
            "install face_alignment, or train the native net "
            "(apps/train_keypoints.py) and pass --kpt_weights")
    from PIL import Image

    from morphablediffusion_torch.eval.keypoint_net import detect, load_params

    size = kpt_size  # run the net at its training resolution
    net = load_params(kpt_weights, device)
    im = Image.fromarray((img * 255).astype(np.uint8)).resize(
        (size, size), Image.BILINEAR)
    kpts = detect(net, np.asarray(im, np.float32)[None] / 255.0)[0]
    scale = np.asarray([img.shape[1], img.shape[0]], np.float32) / size
    return kpts * scale


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input_img", type=str, required=True,
                        help="identity photo")
    parser.add_argument("--exp_img", type=str, default="",
                        help="expression photo (defaults to input_img)")
    parser.add_argument("--flame", type=str, required=True,
                        help="FLAME2020 generic_model.pkl")
    parser.add_argument("--lmk_embedding", type=str, required=True,
                        help="landmark_embedding.npy")
    parser.add_argument("--out", type=str, required=True,
                        help="output fitted mesh .ply")
    parser.add_argument("--kpt_weights", type=str, default="",
                        help="landmark-net weights: the port's .pt "
                             "(apps/train_keypoints.py) or the JAX package's "
                             ".msgpack (artifacts/landmark_net_synth.msgpack)")
    parser.add_argument("--kpt_size", type=int, default=128,
                        help="inference resolution for the native landmark "
                             "net: use the resolution it was trained at")
    parser.add_argument("--input_landmarks", type=str, default="",
                        help="precomputed (68,2) .npy/.json for input_img")
    parser.add_argument("--exp_landmarks", type=str, default="")
    parser.add_argument("--steps", type=int, default=40,
                        help="Levenberg-Marquardt iterations per stage")
    parser.add_argument("--n_shape", type=int, default=100)
    parser.add_argument("--n_exp", type=int, default=50)
    parser.add_argument("--focal", type=float, default=0.0,
                        help="fitting focal length in px (default: 1.2*max(H,W))")
    parser.add_argument("--silhouette", action="store_true",
                        help="add the silhouette LM stage: matte each photo "
                             "with the native backend (preprocessing/"
                             "matting.py) and couple the fit to the matte "
                             "contour (fitting/silhouette.py)")
    parser.add_argument("--overlay", type=str, default="",
                        help="write a PNG of the input photo with the "
                             "detected landmarks (green) and the fitted "
                             "mesh's reprojected landmarks (red)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.fitting import FitConfig, fit_two_photos, load_model
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.mesh_io import save_ply

    device = resolve_device(flags.device)
    img_in = _load_image(flags.input_img)
    img_exp = _load_image(flags.exp_img or flags.input_img)
    lmk_in = _detect(img_in, flags.input_landmarks, flags.kpt_weights, flags.kpt_size,
                     device)
    lmk_exp = _detect(img_exp, flags.exp_landmarks, flags.kpt_weights, flags.kpt_size,
                      device)

    model = load_model(flags.flame, flags.lmk_embedding, n_shape=flags.n_shape,
                       n_exp=flags.n_exp, device=device)
    H, W = img_exp.shape[:2]
    f = flags.focal or 1.2 * max(H, W)
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

    mask_in = mask_exp = None
    if flags.silhouette:
        from morphablediffusion_torch.preprocessing.matting import matte

        def _mask(img):
            rgba = matte((np.clip(img, 0, 1) * 255).astype(np.uint8), backend="native")
            return rgba[..., 3] > 127

        mask_in, mask_exp = _mask(img_in), _mask(img_exp)
    verts, info = fit_two_photos(
        model, lmk_in, lmk_exp, K, FitConfig(steps_per_stage=flags.steps),
        mask_input=mask_in, mask_exp=mask_exp)
    out = Path(flags.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_ply(out, verts, model.faces.cpu().numpy())
    for k, v in info.items():
        print(f"  {k}: {v:.5f}", file=sys.stderr)
    print(f"fitted mesh -> {out} ({len(verts)} verts)")

    if flags.overlay:
        _overlay(flags, model, img_in, lmk_in, K, info)
    return info


def _overlay(flags, model, img_in, lmk_in, K, info):
    """Fit the input photo again (as the JAX CLI does) and paint its
    detected (green) and reprojected (red) landmarks; the input fit's
    reprojection error goes into info["overlay_mean_px_err"]."""
    import torch
    from PIL import Image

    from morphablediffusion_torch.fitting import FitConfig, fit_landmarks
    from morphablediffusion_torch.fitting.flame import (
        flame_forward,
        flame_landmarks,
        project_points,
    )

    p_in, info_in = fit_landmarks(model, lmk_in, K, FitConfig(steps_per_stage=flags.steps))
    t = {k: torch.as_tensor(v, device=model.device) for k, v in p_in.items()}
    with torch.no_grad():
        v_in = flame_forward(model, t["shape"], t["exp"], t["pose"])
        uv = project_points(flame_landmarks(model, v_in, t["pose"]), t["cam_r"], t["cam_t"],
                            torch.as_tensor(K, device=model.device)).cpu().numpy()
    canvas = (img_in * 255).astype(np.uint8).copy()

    def dot(x, y, color, r=2):
        xs = slice(max(int(x) - r, 0), int(x) + r + 1)
        ys = slice(max(int(y) - r, 0), int(y) + r + 1)
        canvas[ys, xs] = color

    for x, y in lmk_in:
        dot(x, y, (0, 255, 0))          # detected: green
    for x, y in uv:
        dot(x, y, (255, 0, 0), r=1)     # fitted reprojection: red
    Path(flags.overlay).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(canvas).save(flags.overlay)
    info["overlay_mean_px_err"] = info_in["mean_px_err"]
    print(f"overlay (input fit px err {info_in['mean_px_err']:.2f}) -> {flags.overlay}")


if __name__ == "__main__":
    main()
