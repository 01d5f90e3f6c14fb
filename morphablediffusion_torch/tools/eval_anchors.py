"""Trivial-baseline anchors for the eval harness (the SSIM/PSNR floor).

The port's counterpart of the repository's `tools/eval_anchors.py`. It
grades two trivial predictors under exactly the eval harness's protocol
(white-composite load, the prediction masked by the ground truth's alpha,
as `apps/eval_2d.py`):

  * copy-input: every target view predicted by the (masked) input view:
    the "is the model using the camera and mesh conditioning at all" anchor;
  * noise: uniform random pixels: the floor.

Target views equal to the input view are excluded and counted (copy-input
is exact there).

    python -m morphablediffusion_torch.tools.eval_anchors --data_dir /tmp/synth/data \
        --views_json /tmp/synth/eval/views.json --image_size 128 [--out anchors.json]

It runs on the host. The JSON has the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--views_json", required=True)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from morphablediffusion_torch.data.common import load_mask, load_rgba_white
    from morphablediffusion_torch.eval import metrics as M

    meta = json.loads(Path(args.views_json).read_text())
    rng = np.random.default_rng(args.seed)
    S = args.image_size

    def load(subject, exp, view):
        p = (Path(args.data_dir) / subject / exp / f"view_{int(view):05d}"
             / "rgba_colorcalib.png")
        img = (load_rgba_white(p, S) + 1) / 2
        return img, load_mask(p, S)

    rows = {"copy_input": {"ssim": [], "psnr": []}, "noise": {"ssim": [], "psnr": []}}
    per_pair = []
    n = n_identity = 0
    for subject in meta:
        for exp, m in meta[subject].items():
            inp, _ = load(subject, exp, m["input_view"])
            for v in m["target_views"]:
                n += 1
                if int(v) == int(m["input_view"]):
                    n_identity += 1
                    continue
                gt, mask = load(subject, exp, v)
                for name, pred in (
                    ("copy_input", inp),
                    ("noise", rng.uniform(size=gt.shape).astype(np.float32)),
                ):
                    pm = M.masked(pred, mask)  # protocol: mask by GT alpha
                    rows[name]["ssim"].append(M.ssim(pm, gt))
                    rows[name]["psnr"].append(M.psnr(pm, gt))
                per_pair.append(f"{subject}/{exp}/{int(v):05d}")
    result = {
        "pairs_total": n,
        "pairs_scored": n - n_identity,
        "identity_pairs_excluded": n_identity,
        **{name: {k: float(np.mean(vals)) for k, vals in d.items()}
           for name, d in rows.items()},
        "scored_pairs": per_pair,
    }
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
