"""Train the in-repo 68-landmark detector (`eval/keypoint_net.py`).

Counterpart of the JAX package's `apps/train_keypoints.py`, with the same
flags plus `--device`. It makes PCK producible by this repo alone: the
reference's keypoint stage needs the mmdet + mmpose model zoos
(eval/predict_keypoints.py); here a compact heatmap net is trained on the
user's own FaceScape renders and then drives `eval_keypoints --backend
native`.

Label sources (``--labels``):
  * a kpts JSON (``{image_name: [[x, y] * 68]}``), e.g. one-time mmpose
    output on GT views, after which the zoo is no longer needed;
  * ``mesh:<landmarks.json>``: 68 mesh landmark specs (vertex index or
    barycentric ``[face, w0, w1, w2]``) projected with each view's camera
    from `cameras.json` and the subject's mesh, fully standalone.

Training is Adam (`torch.optim.Adam(lr)`: optax `adam`'s update, eps 1e-8,
eps_root 0) on fp32 parameters, on batches drawn by the JAX CLI's
`np.random.default_rng(seed)` calls, so both packages see the same batches.
The net starts from `keypoint_net.seeded_net(seed)`. The output is the
port's `.pt` (`keypoint_net.save_params`). The net runs on the CUDA card
and raises without one unless `--device cpu` is given.

    python -m morphablediffusion_torch.apps.train_keypoints \\
        --image_dir <root with view_*/rgba_colorcalib.png> \\
        --labels kpts_gt.json --out landmark_net.pt \\
        [--steps 2000 --batch 16 --lr 3e-4 --image_size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _collect_images(image_dir: Path, size: int, with_alpha: bool = False):
    """All rgba/png images under image_dir, keyed the way kpts JSONs are
    (relative path without extension, '/' -> '_'). with_alpha keeps the
    alpha channel (needed by the domain-randomizing compositor)."""
    from PIL import Image

    items = {}
    mode = "RGBA" if with_alpha else "RGB"
    for p in sorted(image_dir.rglob("*.png")):
        key = str(p.relative_to(image_dir).with_suffix("")).replace("/", "_")
        img = Image.open(p).convert(mode).resize((size, size), Image.BILINEAR)
        items[key] = np.asarray(img, np.float32) / 255.0
    return items


def _random_background(H, W, rng):
    """Solid color / smooth gradient / colored blobs: the background
    classes a real photo can have (same taxonomy as tools/eval_matting.py)."""
    kind = rng.integers(3)
    if kind == 0:
        return np.broadcast_to(
            rng.uniform(0, 1, 3).astype(np.float32), (H, W, 3)
        ).copy()
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == 1:
        c0, c1 = rng.uniform(0, 1, (2, 3)).astype(np.float32)
        t = (xx / W * rng.uniform(-1, 1) + yy / H * rng.uniform(-1, 1))
        t = ((t - t.min()) / max(float(np.ptp(t)), 1e-6))[..., None]
        return c0 * (1 - t) + c1 * t
    bg = np.full((H, W, 3), rng.uniform(0, 1, 3), np.float32)
    for _ in range(rng.integers(4, 10)):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        r = rng.uniform(0.05, 0.3) * H
        m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        bg[m] = rng.uniform(0, 1, 3)
    return bg


def augment_batch(rgba: np.ndarray, kpts: np.ndarray, rng):
    """Domain randomization for landmark training: random backgrounds
    behind the GT alpha, global color jitter, and a random scale/shift whose
    exact transform is applied to the labels. rgba: (B, H, W, 4) in [0, 1];
    kpts: (B, 68, 2) pixels. Returns (images (B, H, W, 3), kpts'), the same
    shapes, a new distribution."""
    from PIL import Image

    B, H, W, _ = rgba.shape
    out_x = np.empty((B, H, W, 3), np.float32)
    out_y = np.empty_like(kpts)
    for i in range(B):
        fg, alpha = rgba[i, ..., :3], rgba[i, ..., 3:]
        img = fg * alpha + _random_background(H, W, rng) * (1 - alpha)
        # scale/shift as a crop-resize: window of side s*H at offset (oy, ox)
        s = rng.uniform(0.8, 1.0)
        hh, ww = int(round(s * H)), int(round(s * W))
        oy = rng.integers(0, H - hh + 1)
        ox = rng.integers(0, W - ww + 1)
        crop = img[oy : oy + hh, ox : ox + ww]
        img = np.asarray(
            Image.fromarray((crop * 255).astype(np.uint8)).resize(
                (W, H), Image.BILINEAR
            ), np.float32,
        ) / 255.0
        y = (kpts[i] - [ox, oy]) * [W / ww, H / hh]
        # photometric: per-channel gain + bias, occasional blur
        img = img * rng.uniform(0.7, 1.3, 3) + rng.uniform(-0.1, 0.1, 3)
        if rng.uniform() < 0.3:
            k = np.ones((3, 3), np.float32) / 9.0
            pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
            img = sum(
                pad[dy : dy + H, dx : dx + W] * k[dy, dx]
                for dy in range(3) for dx in range(3)
            )
        out_x[i] = np.clip(img, 0, 1)
        out_y[i] = y
    return out_x, out_y


def _labels_from_json(path: Path):
    data = json.loads(path.read_text())
    return {k: np.asarray(v, np.float32)[:, :2] for k, v in data.items()}


def _landmarks_3d(spec, mesh_path: str):
    from morphablediffusion_torch.utils.mesh_io import load_mesh

    verts, faces = load_mesh(mesh_path)
    pts = []
    for lm in spec:
        if isinstance(lm, int):
            pts.append(verts[lm])
        else:
            f, w0, w1, w2 = lm
            tri = verts[np.asarray(faces[int(f)])]
            pts.append(w0 * tri[0] + w1 * tri[1] + w2 * tri[2])
    return np.asarray(pts, np.float32)  # (68, 3)


def _labels_from_mesh(spec_path: Path, image_dir: Path, mesh_path: Path,
                      size: int):
    """Project 68 mesh landmarks into every view via cameras.json.

    ``--mesh`` may contain ``{subject}``/``{exp}`` placeholders resolved
    from each cameras.json's relative path (<subject>/<exp>/cameras.json),
    so one invocation trains across every subject of a dataset tree."""
    spec = json.loads(spec_path.read_text())
    template = str(mesh_path)
    cache = {}

    labels = {}
    for cam_file in sorted(image_dir.rglob("cameras.json")):
        cams = json.loads(cam_file.read_text())
        rel = cam_file.parent.relative_to(image_dir)
        resolved = template
        if "{subject}" in template or "{exp}" in template:
            parts = rel.parts
            resolved = template.format(
                subject=parts[0] if parts else "",
                exp=parts[1] if len(parts) > 1 else "",
            )
        if resolved not in cache:
            cache[resolved] = _landmarks_3d(spec, resolved)
        pts = cache[resolved]
        for view, cam in cams.items():
            K = np.asarray(cam["intrinsics"], np.float32)
            RT = np.asarray(cam["extrinsics"], np.float32)
            pc = pts @ RT[:, :3].T + RT[:, 3]
            uv = pc @ K.T
            uv = uv[:, :2] / uv[:, 2:3]
            key = str(rel / f"view_{str(view).zfill(5)}_rgba_colorcalib")
            labels[key.replace("/", "_")] = uv * (size / (2 * K[0, 2]))
    return labels


def main(argv=None):
    """Train and save; returns the loss of every step (host floats)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--labels", type=str, required=True,
                        help="kpts JSON path, or mesh:<landmarks.json>")
    parser.add_argument("--mesh", type=str, default="",
                        help="mesh path for mesh: labels")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--augment", action="store_true",
                        help="domain randomization: random backgrounds "
                             "composited behind the GT alpha, color jitter, "
                             "label-consistent scale/shift")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' "
                             "runs on the CPU")
    flags = parser.parse_args(argv)

    import torch

    from morphablediffusion_torch.eval import keypoint_net as kn
    from morphablediffusion_torch.utils import resolve_device

    device = resolve_device(flags.device)
    image_dir = Path(flags.image_dir)
    images = _collect_images(image_dir, flags.image_size,
                             with_alpha=flags.augment)
    if flags.labels.startswith("mesh:"):
        labels = _labels_from_mesh(
            Path(flags.labels[5:]), image_dir, Path(flags.mesh),
            flags.image_size,
        )
    else:
        labels = _labels_from_json(Path(flags.labels))
    keys = sorted(set(images) & set(labels))
    if not keys:
        raise SystemExit(
            f"no (image, label) pairs: {len(images)} images, "
            f"{len(labels)} labels, 0 common keys"
        )
    print(f"{len(keys)} training pairs")
    X = np.stack([images[k] for k in keys])
    Y = np.stack([labels[k] for k in keys])

    # with --augment X still carries the GT alpha (consumed by the
    # compositor), but the net always sees RGB
    net = kn.seeded_net(flags.seed).to(device).train()
    opt = torch.optim.Adam(net.parameters(), lr=flags.lr)

    rng = np.random.default_rng(flags.seed)
    losses = []
    for i in range(flags.steps):
        idx = rng.integers(0, len(keys), min(flags.batch, len(keys)))
        xb, yb = X[idx], Y[idx]
        if flags.augment:
            xb, yb = augment_batch(xb, yb, rng)
        xt = torch.as_tensor(np.ascontiguousarray(xb[..., :3]), device=device)
        loss = kn.keypoint_loss(net, xt.permute(0, 3, 1, 2).contiguous(),
                                torch.as_tensor(yb, device=device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % flags.log_every == 0:
            print(f"step {i} loss {float(losses[-1]):.5f}", flush=True)

    kn.save_params(flags.out, net)
    print(f"saved landmark net to {flags.out}")
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
