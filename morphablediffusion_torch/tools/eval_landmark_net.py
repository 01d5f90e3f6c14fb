"""Held-out evaluation of a landmark net, with optional domain shift.

The port's counterpart of the repository's `tools/eval_landmark_net.py`. It
measures PCK@0.2, PCK@0.5 and the mean and median pixel error of a trained
`eval/keypoint_net.py` net (the port's `.pt` or the JAX package's
`.msgpack`, such as the shipped `artifacts/landmark_net_synth.msgpack`) on
a held-out subject tree (ground truth: the 68 mesh landmarks projected into
each view, the label source `apps/train_keypoints.py --labels mesh:` trains
on), in two conditions:

  * plain: the renders as stored, composited over white;
  * shifted: each render composited over a random background with the
    photometric jitter of `train_keypoints.augment_batch` (no geometric
    transform, so the labels are unchanged): the measurable half of the
    synthetic-to-photo gap.

    python -m morphablediffusion_torch.tools.eval_landmark_net --weights net.msgpack \
        --image_dir /tmp/synthkp/test_data --landmarks /tmp/synthkp/landmarks.json \
        --mesh "/tmp/synthkp/flame/{subject}/{exp}/mesh.obj" --image_size 128 \
        [--shifted] [--out eval.json] [--device cpu]

The net runs on the CUDA card (it exits non-zero without one unless
`--device cpu` is given). The JSON has the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--landmarks", required=True,
                    help="landmarks.json (68 mesh landmark specs)")
    ap.add_argument("--mesh", required=True,
                    help="mesh path template with {subject}/{exp}")
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--shifted", action="store_true",
                    help="composite random backgrounds + photometric jitter "
                         "(labels unchanged)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card (exits non-zero without one)")
    flags = ap.parse_args(argv)

    from morphablediffusion_torch.apps.train_keypoints import (
        _collect_images,
        _labels_from_mesh,
        _random_background,
    )
    from morphablediffusion_torch.eval.keypoint_net import detect, load_params
    from morphablediffusion_torch.eval.metrics import pck
    from morphablediffusion_torch.utils import resolve_device

    device = resolve_device(flags.device)
    image_dir = Path(flags.image_dir)
    S = flags.image_size
    images = _collect_images(image_dir, S, with_alpha=True)
    labels = _labels_from_mesh(Path(flags.landmarks), image_dir, Path(flags.mesh), S)
    keys = sorted(set(images) & set(labels))
    if not keys:
        raise SystemExit(f"no pairs: {len(images)} images, {len(labels)} labels")

    rng = np.random.default_rng(flags.seed)
    X = np.empty((len(keys), S, S, 3), np.float32)
    for i, k in enumerate(keys):
        fg, alpha = images[k][..., :3], images[k][..., 3:]
        if flags.shifted:
            img = fg * alpha + _random_background(S, S, rng) * (1 - alpha)
            img = img * rng.uniform(0.7, 1.3, 3) + rng.uniform(-0.1, 0.1, 3)
            X[i] = np.clip(img, 0, 1)
        else:
            X[i] = fg * alpha + (1 - alpha)  # white composite, as trained
    Y = np.stack([labels[k] for k in keys])

    net = load_params(flags.weights, device)
    pred = detect(net, X)

    err = np.linalg.norm(pred - Y, axis=-1)
    result = {
        "weights": flags.weights,
        "condition": "shifted" if flags.shifted else "plain",
        "n_views": len(keys),
        "pck_0.2": round(pck(pred, Y, 0.2), 4),
        "pck_0.5": round(pck(pred, Y, 0.5), 4),
        "mean_px": round(float(err.mean()), 3),
        "median_px": round(float(np.median(err)), 3),
        "image_size": S,
    }
    print(json.dumps(result, indent=1))
    if flags.out:
        Path(flags.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
