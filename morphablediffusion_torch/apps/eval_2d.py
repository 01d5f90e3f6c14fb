"""Eval stage 4: 2D quality metrics over generated FaceScape views.

Counterpart of the JAX package's `apps/eval_2d.py`, with the same flags
plus `--device`. Parity target: eval/eval_2d_facescape.py: per (subject,
expression), load the generated strip `{subject}_{exp}.png`, mask each
generated view by the GT alpha (:95), accumulate SSIM / LPIPS / FID /
PCK@0.2 / Re-ID and print the summary line (:139). PSNR is reported too.

All five reference metrics are computed in-repo:
  * SSIM / PSNR / PCK: numpy on the host (`eval/metrics.py`).
  * FID: Frechet distance over CLIP-tower features of the model's own frozen
    CLIP encoder (`--ckpt`, a reference .ckpt/.pt/.pth read by the port's
    importer; the JAX package's Orbax directories are not read). The
    reference uses InceptionV3 features (torchmetrics); the default
    --fid_backend auto picks that backend whenever torchmetrics imports,
    else CLIP-FID, whose absolute values are not comparable across feature
    spaces but which ranks models the same way.
  * Re-ID: IR-SE50 ArcFace descriptors (`eval/irse.py`, --reid_weights
    model_ir_se50.pth), Euclidean distance < --reid_threshold, which is
    required with those weights (calibrate it with `apps/calibrate_reid.py`).
  * LPIPS: the VGG backend (`eval/lpips_vgg.py`) on the published
    torchvision vgg16 and lpips calibration files (--lpips_vgg
    vgg16-397923af.pth --lpips_lin vgg.pth), else the external `lpips`
    package if it imports, else null.

The networks (CLIP, IR-SE50, LPIPS) run on the CUDA card; a run that asks
for one raises without a card unless `--device cpu` is given.

    python -m morphablediffusion_torch.apps.eval_2d --data_dir <root> \\
        --generated_dir eval_out --views_json eval/facescape_input_target_views.json \\
        [--ckpt ckpt/facescape_flame.ckpt --cfg configs/facescape.yaml] \\
        [--reid_weights model_ir_se50.pth --reid_threshold T] \\
        [--lpips_vgg vgg16-397923af.pth --lpips_lin vgg.pth] \\
        [--pred_kpts kpts_gen.json --gt_kpts kpts_gt.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from morphablediffusion_torch.eval import metrics as M


def _load_strip(path, size=256):
    from PIL import Image

    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    n = img.shape[1] // size
    return [img[:, i * size : (i + 1) * size, :3] for i in range(n)]


def _load_gt(view_dir, size=256):
    from morphablediffusion_torch.data.common import load_mask, load_rgba_white

    img = (load_rgba_white(view_dir / "rgba_colorcalib.png", size) + 1) / 2
    mask = load_mask(view_dir / "rgba_colorcalib.png", size)
    return img, mask


def _load_clip_encoder(ckpt_path: str, cfg_path: str, device):
    """The CLIP tower of a reference checkpoint, whole-model or the tower
    alone (its `clip_image_encoder.model.visual.*` keys, through the port's
    importer), fp32 on `device`; the config (or `Config()`) gives its
    dimensions."""
    from torch import nn

    from morphablediffusion_torch.apps.generate_face import REFERENCE_SUFFIXES
    from morphablediffusion_torch.models.clip import CLIPImageEncoder
    from morphablediffusion_torch.utils.config import Config, load_config
    from morphablediffusion_torch.utils.torch_import import (
        import_state_dict,
        load_torch_state_dict,
    )

    if not str(ckpt_path).endswith(REFERENCE_SUFFIXES):
        raise SystemExit(f"--ckpt {ckpt_path}: the port reads the CLIP tower from a "
                         "reference .ckpt/.pt/.pth; a JAX Orbax directory cannot be "
                         "read without JAX")
    cfg = load_config(cfg_path) if cfg_path else Config()
    c = cfg.model.clip
    holder = nn.Module()  # the importer's paths start at the model's root
    holder.clip_image_encoder = CLIPImageEncoder(
        width=c.width, layers=c.layers, num_heads=c.num_heads, patch_size=c.patch_size,
        output_dim=c.output_dim)
    holder.to(device)
    # only the tower's keys: the importer pads the UNet's input conv when it
    # finds that key, which a model without a UNet cannot take (the JAX app
    # raises KeyError: 'unet' on a whole-model checkpoint)
    sd = {k: v for k, v in load_torch_state_dict(ckpt_path).items()
          if k.startswith("clip_image_encoder.")}
    report = import_state_dict(sd, holder, clip_layers=c.layers)
    print(f"clip tower: {report['filled']} tensors imported")
    return holder.clip_image_encoder.eval()


def _clip_features(images, encoder, chunk=16):
    """(N, H, W, 3) [0,1] -> (N, D) CLIP embeddings, in chunks."""
    arr = np.stack(images)
    feats = np.concatenate([M.clip_features(arr[lo : lo + chunk], encoder)
                            for lo in range(0, len(arr), chunk)])
    return feats.reshape(feats.shape[0], -1)


def _inception_fid(real, fake):
    """Reference-exact FID via torchmetrics InceptionV3, if importable."""
    import torch
    from torchmetrics.image.fid import FrechetInceptionDistance

    fid = FrechetInceptionDistance()
    to8 = lambda ims: torch.from_numpy(
        (np.stack(ims) * 255).astype(np.uint8)
    ).permute(0, 3, 1, 2)
    fid.update(to8(real), real=True)
    fid.update(to8(fake), real=False)
    return float(fid.compute().item())


def main(argv=None):
    """Compute the metrics; prints the reference's summary line and the
    result JSON, and returns the result dict."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--generated_dir", type=str, required=True)
    parser.add_argument("--views_json", type=str,
                        default="./eval/facescape_input_target_views.json")
    parser.add_argument("--mode", type=str, default="nes", choices=["nvs", "nes"])
    parser.add_argument("--pred_kpts", type=str, default="")
    parser.add_argument("--gt_kpts", type=str, default="")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--ckpt", type=str, default="",
                        help="reference model checkpoint (.ckpt/.pt/.pth) "
                             "providing the CLIP tower for FID features")
    parser.add_argument("--cfg", type=str, default="",
                        help="model config yaml (CLIP dims for --ckpt)")
    parser.add_argument("--fid_backend", type=str, default="auto",
                        choices=["auto", "clip", "inception"],
                        help="inception: reference-exact (torchmetrics, "
                             "eval_2d_facescape.py:110-139); clip: "
                             "CLIP-FID; auto (default): "
                             "inception when torchmetrics imports, else clip")
    parser.add_argument("--reid_weights", type=str, default="",
                        help="IR-SE50 ArcFace weights (model_ir_se50.pth) "
                             "for the Re-ID rate")
    parser.add_argument("--reid_threshold", type=float, default=None,
                        help="Re-ID accept distance. REQUIRED with "
                             "--reid_weights: the reference's 0.6 is dlib's "
                             "calibrated threshold (eval_2d_facescape.py:"
                             "97-108) and is known-wrong for IR-SE50's "
                             "distance scale; run apps/calibrate_reid.py "
                             "on a multi-view tree with the same weights "
                             "and pass its EER threshold")
    parser.add_argument("--lpips_vgg", type=str, default="",
                        help="torchvision vgg16 weights "
                             "(vgg16-397923af.pth) for native LPIPS")
    parser.add_argument("--lpips_lin", type=str, default="",
                        help="lpips v0.1 vgg calibration weights "
                             "(vgg.pth) for native LPIPS")
    parser.add_argument("--device", type=str, default=None,
                        help="where the networks run: default the CUDA card "
                             "(raises without one); 'cpu' runs on the CPU")
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.utils import resolve_device

    metadata = json.loads(Path(flags.views_json).read_text())
    gen_dir = Path(flags.generated_dir)

    if flags.reid_weights and flags.reid_threshold is None:
        raise SystemExit(
            "--reid_weights needs an explicit --reid_threshold: the "
            "dlib default (0.6) does not transfer to IR-SE50's distance "
            "scale, so a silently-computed rate would be wrong. "
            "Calibrate one with\n"
            "  python -m morphablediffusion_torch.apps.calibrate_reid "
            f"--data_dir <multi-view tree> --reid_weights "
            f"{flags.reid_weights} --pairing same_view --out cal.json\n"
            "and pass its printed EER threshold here.")
    fid_backend = flags.fid_backend
    if fid_backend == "auto":
        # reference-exact Inception FID whenever torchmetrics is available
        # (eval_2d_facescape.py:110-139); CLIP-FID otherwise
        try:
            import torchmetrics  # noqa: F401

            fid_backend = "inception"
        except ImportError:
            fid_backend = "clip"
    native_lpips = bool(flags.lpips_vgg and flags.lpips_lin)
    lpips_pkg = None
    if not native_lpips:
        try:
            import lpips as lpips_pkg
        except ImportError:
            lpips_pkg = None
    # every network runs on one device, resolved once (none for numpy only)
    device = (resolve_device(flags.device)
              if native_lpips or lpips_pkg is not None or flags.reid_weights
              or (flags.ckpt and fid_backend == "clip") else None)

    lpips_fn = None
    if native_lpips:
        from morphablediffusion_torch.eval.lpips_vgg import load_lpips

        dist = load_lpips(flags.lpips_vgg, flags.lpips_lin, device)
        lpips_fn = lambda a, b: float(dist([a], [b])[0])
    elif lpips_pkg is not None:
        import torch

        try:
            lpips_model = lpips_pkg.LPIPS(net="vgg").to(device)
        except Exception as e:  # its weights could not be loaded: LPIPS stays null
            print(f"lpips package unusable: {e!r}")
        else:
            def lpips_fn(a, b):
                t = lambda x: torch.from_numpy((x * 2 - 1).transpose(2, 0, 1)[None]).float()
                with torch.no_grad():
                    return float(lpips_model(t(a).to(device), t(b).to(device)).item())

    reid_fn = None
    if flags.reid_weights:
        from morphablediffusion_torch.eval.irse import face_descriptors, load_irse50

        irse = load_irse50(flags.reid_weights, device)
        print(f"irse50: {len(irse.state_dict())} tensors loaded")
        reid_fn = lambda ims: face_descriptors(np.stack(ims), irse)

    ssims, psnrs, lpipss, reid_dists = [], [], [], []
    real_imgs, fake_imgs = [], []
    n_pairs = 0
    for strip_path in sorted(gen_dir.glob("*_*.png")):
        subject, exp = strip_path.stem.split("_")
        meta = metadata.get(subject.zfill(3), metadata.get(subject, {})).get(exp)
        if not meta:
            continue
        views = meta["target_views"]
        gen_views = _load_strip(strip_path, flags.image_size)
        for i, v in enumerate(views[: len(gen_views)]):
            gt_dir = (
                Path(flags.data_dir) / subject / exp / f"view_{str(v).zfill(5)}"
            )
            if not gt_dir.exists():
                continue
            gt, mask = _load_gt(gt_dir, flags.image_size)
            gen = M.masked(gen_views[i], mask)  # eval_2d_facescape.py:95
            ssims.append(M.ssim(gen, gt))
            psnrs.append(M.psnr(gen, gt))
            if lpips_fn:
                lpipss.append(lpips_fn(gen, gt))
            real_imgs.append(gt)
            fake_imgs.append(gen)
            if reid_fn is not None:
                d = reid_fn([gt, gen])
                reid_dists.append(float(np.linalg.norm(d[0] - d[1])))
            n_pairs += 1

    fid_val = None
    if real_imgs and (flags.ckpt or fid_backend == "inception"):
        if fid_backend == "inception":
            fid_val = _inception_fid(real_imgs, fake_imgs)
        else:
            encoder = _load_clip_encoder(flags.ckpt, flags.cfg, device)
            real_f = _clip_features(real_imgs, encoder)
            fake_f = _clip_features(fake_imgs, encoder)
            fid_val = M.frechet_distance(real_f, fake_f)

    reid_val = (
        M.reid_rate(np.asarray(reid_dists), flags.reid_threshold)
        if reid_dists else None
    )

    pck_val = None
    if flags.pred_kpts and flags.gt_kpts:
        pred = json.loads(Path(flags.pred_kpts).read_text())
        gt = json.loads(Path(flags.gt_kpts).read_text())
        common = sorted(set(pred) & set(gt))
        pck_val = M.pck(
            np.asarray([pred[k] for k in common], np.float64),
            np.asarray([gt[k] for k in common], np.float64),
        )

    result = {
        "pairs": n_pairs,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "fid": fid_val,
        "pck@0.2": pck_val,
        "re_id": reid_val,
    }
    # self-describing nulls: say WHY a metric is absent, in the artifact
    # itself (committed JSONs otherwise carry silent nulls — EVAL.md has
    # the context but the file should stand alone)
    unavailable = {}
    if result["lpips"] is None:
        unavailable["lpips"] = (
            "no LPIPS backend: pass --lpips_vgg/--lpips_lin (vgg16 + lpips "
            "v0.1 calibration weights, non-redistributable; download_data.sh)"
            " or install the `lpips` package"
        )
    if result["re_id"] is None:
        unavailable["re_id"] = (
            "no Re-ID embedder: pass --reid_weights model_ir_se50.pth with a "
            "calibrated --reid_threshold (apps/calibrate_reid.py; EVAL.md §2)"
        )
    if result["fid"] is None:
        unavailable["fid"] = (
            "no FID backend: torchmetrics unavailable and no --ckpt for the "
            "CLIP fallback"
        )
    if unavailable:
        result["unavailable_backends"] = unavailable
    # reference printout shape (eval_2d_facescape.py:139)
    print(
        f"SSIM: {result['ssim']}, LPIPS: {result['lpips']}, "
        f"FID: {result['fid']}, PCK: {result['pck@0.2']}, "
        f"Re-ID: {result['re_id']}"
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
