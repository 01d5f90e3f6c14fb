"""Quantify the port's matting backend against ground-truth alphas.

The port's counterpart of the repository's `tools/eval_matting.py`, on the
port's `preprocessing/matting.py` (the color-model backend that replaces
the reference's carvekit Tracer-B7; it runs on the host). It measures the
backend on composites with KNOWN alpha: RGBA images of a synthetic
multi-view tree (the port's `make_synthetic_facescape` renders carry exact
alphas) are composited onto three background classes, and the recovered
alpha is scored with IoU (alpha > 0.5) and MAE.

Background classes, easiest to hardest for a border-seeded color model:
  * uniform: a flat studio-like color (the pipeline's intended regime);
  * gradient: a smooth two-color ramp;
  * clutter: high-frequency colored blobs (the known failure regime: the
    foreground and background color models overlap).

    python -m morphablediffusion_torch.tools.eval_matting --data_dir /tmp/synth/data \
        [--out matting_eval.json] [--samples 12] [--seed 0]

`--out` defaults to the working directory. The JSON has the JAX tool's
keys (summary, per_image, data_dir, samples).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def backgrounds(shape, rng):
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    uniform = np.broadcast_to(rng.uniform(0.55, 0.95, 3).astype(np.float32), (H, W, 3))
    c0, c1 = rng.uniform(0.2, 1.0, (2, 3))
    t = (xx / W * 0.6 + yy / H * 0.4)[..., None]
    gradient = (c0 * (1 - t) + c1 * t).astype(np.float32)
    clutter = np.zeros((H, W, 3), np.float32) + 0.5
    for _ in range(12):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        r = rng.uniform(0.05, 0.25) * H
        m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        clutter[m] = rng.uniform(0, 1, 3)
    return {"uniform": uniform, "gradient": gradient, "clutter": clutter}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_dir", required=True,
                    help="dataset tree with RGBA pngs (GT alpha)")
    ap.add_argument("--out", default="matting_eval.json")
    ap.add_argument("--samples", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from PIL import Image

    from morphablediffusion_torch.preprocessing.matting import matte

    paths = sorted(Path(args.data_dir).rglob("*.png"))
    if not paths:
        raise SystemExit(f"no pngs under {args.data_dir}")
    rng = np.random.default_rng(args.seed)
    picks = [paths[i] for i in
             rng.choice(len(paths), size=min(args.samples, len(paths)), replace=False)]

    per_bg = {}
    for p in picks:
        rgba = np.asarray(Image.open(p)).astype(np.float32) / 255.0
        if rgba.shape[-1] != 4:
            continue
        fg, gt_alpha = rgba[..., :3], rgba[..., 3]
        for name, bg in backgrounds(gt_alpha.shape, rng).items():
            comp = fg * gt_alpha[..., None] + bg * (1 - gt_alpha[..., None])
            out = matte((comp * 255).astype(np.uint8), backend="native")
            alpha = out[..., 3].astype(np.float32) / 255.0
            mae = float(np.abs(alpha - gt_alpha).mean())
            a, g = alpha > 0.5, gt_alpha > 0.5
            iou = float((a & g).sum() / max((a | g).sum(), 1))
            per_bg.setdefault(name, []).append({"mae": mae, "iou": iou})
            print(f"{p.parent.parent.parent.name}/{p.parent.name} {name}: "
                  f"IoU {iou:.3f} MAE {mae:.3f}", flush=True)

    summary = {
        bg: {
            "iou_mean": float(np.mean([r["iou"] for r in rows])),
            "iou_min": float(np.min([r["iou"] for r in rows])),
            "mae_mean": float(np.mean([r["mae"] for r in rows])),
            "n": len(rows),
        }
        for bg, rows in per_bg.items()
    }
    result = {"summary": summary, "per_image": per_bg, "data_dir": args.data_dir,
              "samples": args.samples}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    for bg, s in summary.items():
        print(f"{bg:9s}: IoU {s['iou_mean']:.3f} (min {s['iou_min']:.3f}) "
              f"MAE {s['mae_mean']:.3f} over {s['n']}")
    print(f"-> {out}")
    return result


if __name__ == "__main__":
    main()
