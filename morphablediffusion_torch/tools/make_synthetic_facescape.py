"""Generate a synthetic multi-view dataset in the FaceScape layout.

The PyTorch port's own copy of the repository's
`tools/make_synthetic_facescape.py` (step 1 of the from-scratch recipe,
`configs/synth_scratch.yaml`): the same files for the same flags, with the
FaceScape conventions and the self-check taken from the port's
`data/facescape.py`.

Purpose: execute the real training recipe on hosts without the licensed
FaceScape assets. Each (subject, expression) is a
procedurally-deformed lambertian ellipsoid "head": subjects vary shape +
albedo pattern, expressions vary a smooth displacement field, and every view
is rendered by splatting backface-culled surface points with a fixed world
light — so the 20 views per item are geometrically and photometrically
consistent, the mesh conditioning is informative (the deformation is visible
in the images), and a diffusion model trained on it has real signal to fit.

Layout produced (matching data/facescape.py and the reference
ldm/data/facescape.py):
  <out>/data/<subject>/<exp>/view_000NN/rgba_colorcalib.png
  <out>/data/<subject>/<exp>/cameras.json     (facescape-convention K/RT)
  <out>/flame/<subject>/<exp>/mesh.obj        (flame_assets_dir topology)

  python -m morphablediffusion_torch.tools.make_synthetic_facescape --out /tmp/synth \
      --subjects 8 --expressions 4 --views 20 --image_size 256
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from morphablediffusion_torch.data.facescape import CAPSTUDIO_2_FACESCAPE, WORLD_SCALE

RADIUS = 4.5          # camera distance in model world (virtual trajectory)
HEAD_SCALE = 0.27     # keeps the head inside the 0.5-length spatial volume


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], axis=-1,
    )


def head_points(subject_seed: int, exp_id: int, n: int) -> tuple:
    """(points (n,3), albedo (n,3)) of the deformed 'head' in model world."""
    rng = np.random.default_rng(subject_seed)
    u = fibonacci_sphere(n)
    radii = HEAD_SCALE * (1.0 + 0.25 * rng.uniform(-1, 1, 3))
    # subject-specific smooth bumps + expression-driven displacement
    freq = rng.uniform(2.0, 4.0, (3, 3))
    phase = rng.uniform(0, 2 * np.pi, 3)
    bump = 0.08 * np.sin(u @ freq.T * 2.0 + phase).sum(-1, keepdims=True) / 3
    e = exp_id / 4.0
    exp_disp = 0.10 * e * np.sin(4.0 * u[:, :1] + 6.0 * u[:, 1:2] + e)
    p = u * radii * (1.0 + bump + exp_disp)
    # albedo: smooth per-subject color field over the surface
    cfreq = rng.uniform(1.0, 3.0, (3, 3))
    alb = 0.5 + 0.5 * np.sin(u @ cfreq.T * 3.0 + rng.uniform(0, 6.3, 3))
    return p.astype(np.float64), np.clip(alb, 0, 1)


def camera_model_world(azim_deg: float, elev_deg: float):
    """RT (3,4) in MODEL world: an origin-look-at camera on the sphere.
    Equals apps/generate_face.generate_camera_trajectory's convention at
    elevation 0 (OpenCV axes, image y pointing down in world)."""
    y = np.radians(azim_deg)
    el = np.radians(elev_deg)
    pos = RADIUS * np.asarray(
        [np.sin(y) * np.cos(el), np.sin(el), np.cos(y) * np.cos(el)]
    )
    z_row = -pos / np.linalg.norm(pos)  # forward: towards the origin
    x_row = np.cross(z_row, np.asarray([0.0, 1.0, 0.0]))
    x_row /= np.linalg.norm(x_row)
    y_row = np.cross(z_row, x_row)  # image y: down
    R = np.stack([x_row, y_row, z_row])
    RT = np.zeros((3, 4))
    RT[:3, :3] = R
    RT[:3, 3] = -R @ pos
    return RT


def render(points, albedo, normals, K, RT, size):
    """Splat lambertian-shaded, backface-culled points; white background."""
    cam = points @ RT[:3, :3].T + RT[:3, 3]
    cam_pos = -RT[:3, :3].T @ RT[:3, 3]
    view_dir = cam_pos[None] - points
    front = (normals * view_dir).sum(-1) > 0
    light = np.asarray([0.4, 0.6, 0.8]) / np.linalg.norm([0.4, 0.6, 0.8])
    shade = (0.35 + 0.65 * np.clip(normals @ light, 0, 1))[:, None]
    color = np.clip(albedo * shade, 0, 1)

    pix = cam[:, :2] / cam[:, 2:3]
    px = (K[0, 0] * pix[:, 0] + K[0, 2]).round().astype(int)
    py = (K[1, 1] * pix[:, 1] + K[1, 2]).round().astype(int)
    img = np.ones((size, size, 3))
    alpha = np.zeros((size, size))
    # far-to-near painter's order (convex-ish shape + backface culling)
    order = np.argsort(-cam[:, 2])
    keep = front[order]
    px, py, c = px[order][keep], py[order][keep], color[order][keep]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x, y = px + dx, py + dy
            ok = (x >= 0) & (x < size) & (y >= 0) & (y < size)
            img[y[ok], x[ok]] = c[ok]
            alpha[y[ok], x[ok]] = 1.0
    out = np.concatenate([img, alpha[..., None]], -1)
    return (out * 255).astype(np.uint8)


def main(argv=None):
    from PIL import Image  # only writing the images needs PIL

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--subjects", type=int, default=8)
    ap.add_argument("--expressions", type=int, default=4)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--points", type=int, default=24000)
    ap.add_argument("--mesh_vertices", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--mark_landmarks", type=str, default="",
        help="landmarks.json (tools/make_synthetic_landmarks.py): paint a "
             "dark dot at each landmark so they are visually defined "
             "features shared across subjects, like real facial landmarks "
             "are for mmpose — the faithful stand-in for PCK calibration",
    )
    args = ap.parse_args(argv)

    out = Path(args.out)
    S = args.image_size
    focal = 1545.23757707405 * S / 256.0
    K = np.asarray([[focal, 0, S / 2], [0, focal, S / 2], [0, 0, 1.0]])
    F2C_inv = np.linalg.inv(
        np.asarray([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    )  # storage convention: _camera() right-multiplies FACESCAPE_2_CAPSTUDIO
    C2F_inv = np.linalg.inv(CAPSTUDIO_2_FACESCAPE)

    azims = np.linspace(-80, 80, args.views)
    rng = np.random.default_rng(args.seed)
    elevs = rng.uniform(-12, 12, args.views)

    lm_near = None
    if args.mark_landmarks:
        lm_ids = json.loads(Path(args.mark_landmarks).read_text())
        u_lm = fibonacci_sphere(args.mesh_vertices)[np.asarray(lm_ids)]
        u_pts = fibonacci_sphere(args.points)
        # render points within ~3.4 degrees of a landmark direction (the
        # deformation field is shared between render and mesh points, so
        # u-space proximity survives onto the deformed surface)
        lm_near = (u_pts @ u_lm.T).max(axis=1) > np.cos(0.06)

    for si in range(args.subjects):
        subject = str(si + 1).zfill(3)
        for ei in range(args.expressions):
            exp = str(ei + 1).zfill(2)
            pts, alb = head_points(1000 + si, ei, args.points)
            normals = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
            if lm_near is not None:
                alb[lm_near] = alb[lm_near] * 0.1 + [0.25, 0.02, 0.02]

            d = out / "data" / subject / exp
            cams = {}
            for vi in range(args.views):
                RT_m = camera_model_world(azims[vi], elevs[vi])
                img = render(pts, alb, normals, K, RT_m, S)
                p = d / f"view_{str(vi).zfill(5)}" / "rgba_colorcalib.png"
                p.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(img, "RGBA").save(p)
                RT_fs = RT_m.copy()
                RT_fs[:3, :3] = RT_m[:3, :3] @ F2C_inv
                RT_fs[:3, 3] = RT_m[:3, 3] / WORLD_SCALE
                cams[str(vi)] = {
                    "intrinsics": K.tolist(),
                    "extrinsics": RT_fs.tolist(),
                    "angles": {"azimuth": float(azims[vi]),
                               "elevation": float(elevs[vi])},
                }
            (d / "cameras.json").write_text(json.dumps(cams))

            mpts, _ = head_points(1000 + si, ei, args.mesh_vertices)
            v_store = (C2F_inv @ mpts.T).T / WORLD_SCALE
            m = out / "flame" / subject / exp / "mesh.obj"
            m.parent.mkdir(parents=True, exist_ok=True)
            m.write_text(
                "".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v_store)
            )
        print(f"subject {subject}: {args.expressions} expressions done")

    # self-check: the dataset class must accept what we wrote
    from morphablediffusion_torch.data.facescape import FaceScapeDataset

    uids = [f"{str(s + 1).zfill(3)}/{str(e + 1).zfill(2)}"
            for s in range(args.subjects) for e in range(args.expressions)]
    ds = FaceScapeDataset(
        str(out / "data"), uids, image_size=S,
        num_views=min(16, args.views), max_vertices=args.mesh_vertices + 64,
        flame_assets_dir=str(out / "flame"), shuffled_expression=False,
    )
    item = ds[0]
    assert np.isfinite(item["target_image"]).all()
    assert item["vertex_mask"].sum() == args.mesh_vertices
    print(f"wrote {len(uids)} uids under {out}; dataset self-check ok")


if __name__ == "__main__":
    main()
