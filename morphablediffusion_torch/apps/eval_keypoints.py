"""Eval stage 3: 68-keypoint prediction on GT and generated views.

Counterpart of the JAX package's `apps/eval_keypoints.py`, with the same
flags plus `--device`. Parity target: eval/predict_keypoints.py(.sh): the
reference shells out to mmdet (YOLOX face detector) + mmpose (HRNetV2 68-kpt
top-down) and writes a kpts JSON per image set. The same artifact contract
with three backends:

  --backend native: the in-repo landmark detector (`eval/keypoint_net.py`,
      trained with `apps/train_keypoints.py`) over every image in
      --image_dir, on the CUDA card (it raises without one unless `--device
      cpu` is given).
  --backend command: an arbitrary user command per image directory that
      must produce the JSON (bring-your-own mmpose/face-alignment env).
  --backend precomputed: validate and pass through an existing kpts JSON.

The last two run on the host only. Output JSON: {image_name: [[x, y] * 68]},
consumed by eval_2d's PCK@0.2.

    python -m morphablediffusion_torch.apps.eval_keypoints --image_dir <root> \\
        --output kpts_gt.json --weights landmark_net.pt [--views_json ...] \\
        [--strips] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np


def _iter_view_images(image_dir: Path, views_json: str):
    """Yield (key, PIL image) over per-view GT images; when views_json is
    given, restrict to its subjects/expressions (saves re-detecting the whole
    dataset when only the held-out eval subjects matter)."""
    from PIL import Image

    allow = None
    if views_json:
        meta = json.loads(Path(views_json).read_text())
        # subject keys are zero-padded in the stage-1 JSON but may be
        # unpadded on disk (and vice versa): admit both spellings, matching
        # the zfill(3) normalization of eval_generate and _iter_strip_tiles
        allow = {(sk, e) for s in meta for e in meta[s]
                 for sk in (s, s.zfill(3), s.lstrip("0") or "0")}
    for p in sorted(image_dir.rglob("*.png")):
        rel = p.relative_to(image_dir)
        if allow is not None:
            if len(rel.parts) < 3 or (rel.parts[0], rel.parts[1]) not in allow:
                continue
        yield str(rel.with_suffix("")).replace("/", "_"), Image.open(p)


def _iter_strip_tiles(image_dir: Path, views_json: str):
    """Yield (key, tile) by slicing eval stage-2 strips into square tiles,
    as the reference does inside predict_keypoints.py:219-232. Tile i is
    target_views[i] of the stage-1 JSON; keys mirror the GT scan's
    `{subject}_{exp}_view_{v:05d}_rgba_colorcalib` naming so eval_2d can
    intersect pred/GT key sets directly."""
    from PIL import Image

    meta = json.loads(Path(views_json).read_text())
    for p in sorted(image_dir.glob("*_*.png")):
        # strips are named {subject}_{exp}.png; skip stray files whose stem
        # doesn't match (e.g. view_00001_rgba copies dropped in the dir)
        parts = p.stem.split("_")
        if len(parts) != 2:
            continue
        subject, exp = parts
        m = meta.get(subject.zfill(3), meta.get(subject, {})).get(exp)
        if not m:
            continue
        strip = Image.open(p)
        side = strip.height
        for i, v in enumerate(m["target_views"][: strip.width // side]):
            key = f"{subject}_{exp}_view_{str(v).zfill(5)}_rgba_colorcalib"
            yield key, strip.crop((i * side, 0, (i + 1) * side, side))


def _native(images, weights: str, image_size: int, device):
    from PIL import Image

    from morphablediffusion_torch.eval.keypoint_net import detect, load_params

    net = load_params(weights, device)
    keys, imgs, scales = [], [], []
    for key, im in images:
        im = im.convert("RGB")
        scales.append(np.asarray(im.size, np.float32) / image_size)
        im = im.resize((image_size, image_size), Image.BILINEAR)
        keys.append(key)
        imgs.append(np.asarray(im, np.float32) / 255.0)
    if not keys:
        raise SystemExit("no images matched")
    kpts = detect(net, np.stack(imgs))  # (N, 68, 2) at image_size
    # report in the original pixel grid of each image
    kpts = kpts * np.stack(scales)[:, None, :]
    return {k: kpts[i].tolist() for i, k in enumerate(keys)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--backend", type=str, default="native",
                        choices=["native", "command", "precomputed"])
    parser.add_argument("--weights", type=str, default="",
                        help="landmark net weights (train_keypoints --out)")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--command", type=str, default="",
                        help="shell command; {image_dir} and {output} are "
                             "substituted")
    parser.add_argument("--precomputed", type=str, default="")
    parser.add_argument("--strips", action="store_true",
                        help="treat --image_dir's {subject}_{exp}.png files "
                             "as stage-2 view strips and slice them into "
                             "square tiles (predict_keypoints.py:219-232); "
                             "requires --views_json for the tile->view map")
    parser.add_argument("--views_json", type=str, default="",
                        help="stage-1 JSON: restricts a GT scan to its "
                             "subjects/expressions, and maps strip tiles "
                             "to view ids with --strips")
    parser.add_argument("--device", type=str, default=None,
                        help="--backend native: default the CUDA card (raises "
                             "without one); 'cpu' runs on the CPU")
    flags = parser.parse_args(argv)

    out = Path(flags.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    if flags.backend == "native":
        from morphablediffusion_torch.utils import resolve_device

        device = resolve_device(flags.device)
        if not flags.weights:
            raise SystemExit("--backend native needs --weights "
                             "(see apps/train_keypoints.py)")
        if flags.strips:
            if not flags.views_json:
                raise SystemExit("--strips needs --views_json")
            images = _iter_strip_tiles(Path(flags.image_dir), flags.views_json)
        else:
            images = _iter_view_images(Path(flags.image_dir), flags.views_json)
        data = _native(images, flags.weights, flags.image_size, device)
        out.write_text(json.dumps(data))
    elif flags.backend == "command":
        cmd = flags.command.format(image_dir=flags.image_dir, output=flags.output)
        subprocess.run(cmd, shell=True, check=True)
    else:
        src = Path(flags.precomputed or flags.output)
        data = json.loads(src.read_text())
        for name, kpts in data.items():
            if len(kpts) != 68:
                raise SystemExit(f"{name}: expected 68 keypoints, found {len(kpts)}")
        if src != out:
            out.write_text(json.dumps(data))
    kpts = json.loads(out.read_text())
    print(f"keypoints for {len(kpts)} images at {out}")


if __name__ == "__main__":
    main()
