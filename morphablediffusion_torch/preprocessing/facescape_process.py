"""FaceScape raw-capture -> training-layout processing.

The PyTorch port's own copy of the JAX package's
`preprocessing/facescape_process.py` (numpy and OpenCV, on the host).

Reproduces the reference's per-subject pipeline and on-disk contract
(preprocessing/facescape/process_dataset.py): per expression, read
`params.json` multi-camera calibration, align the world with
`Rt_scale_dict.json` into the CAPSTUDIO convention (z up, face toward -y,
metres), undistort each valid view, render the registered mesh's depth for a
foreground mask, side-aware square crop with padding, adjust K, resize to
256, write `view_XXXXX/rgba.png` + `cameras.json` (intrinsics/extrinsics/
azimuth+elevation angles), optionally dump the bilinear-topology vertices,
then run cross-view color calibration producing `rgba_colorcalib.png` and
delete the uncalibrated images.

Self-contained: depth rendering uses the native C++ rasterizer (no
pyrender/EGL); mesh IO uses utils.mesh_io (no trimesh/openmesh).

Usage:
    python -m morphablediffusion_torch.preprocessing.facescape_process \
        --dir_in FACESCAPE_RAW/1 --dir_out FACESCAPE_PROCESSED/001 \
        --rt_scale_dict assets/Rt_scale_dict.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from morphablediffusion_torch.preprocessing.color_calib import calibrate_colors
from morphablediffusion_torch.preprocessing.raster import render_depth_cv
from morphablediffusion_torch.utils.mesh_io import load_mesh, load_obj

FACESCAPE_2_CAPSTUDIO = np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
)


def homogeneous(rt34: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4)."""
    pad = np.zeros(rt34.shape[:-2] + (1, 4), rt34.dtype)
    pad[..., 0, 3] = 1.0
    return np.concatenate([rt34, pad], axis=-2)


def invert_rt(rt44: np.ndarray) -> np.ndarray:
    R = rt44[..., :3, :3]
    t = rt44[..., :3, 3:]
    Ri = np.swapaxes(R, -1, -2)
    return homogeneous(np.concatenate([Ri, -Ri @ t], axis=-1)[..., :3, :])


def camera_angles(Rt: np.ndarray, ref_dir=np.array([0.0, 1.0, 0.0])):
    """Azimuth/elevation of the camera view direction wrt +y
    (process_dataset.py:43-59 contract: azimuth sign from x, elevation
    sign from z)."""
    view = Rt[2, :3].copy()
    hor = view.copy()
    hor[2] = 0
    hor = hor / np.linalg.norm(hor)
    vert = view.copy()
    vert[0] = 0
    vert = vert / np.linalg.norm(vert)
    azimuth = float(np.degrees(np.arccos(np.clip(hor @ ref_dir, -1, 1))))
    elevation = float(np.degrees(np.arccos(np.clip(vert @ ref_dir, -1, 1))))
    azimuth *= -1 * np.sign(hor[0])
    elevation *= np.sign(vert[2])
    return dict(azimuth=azimuth, elevation=elevation)


def side_aware_crop(mask, pose, h, w, padding_v=0.01, padding_h=0.05):
    """Square crop anchored at the silhouette edge nearer the camera
    (process_dataset.py:181-208). Returns (top, bottom, left, right)."""
    crop = min(h, w)
    pad_v = int(crop * padding_v)
    pad_h = int(crop * padding_h)
    ys, xs = np.where(mask)
    top = int(ys.min())
    left = int(xs.min())
    right = int(xs.max())
    bt = max(top - pad_v, 0)
    if pose[0, 3] < 0:  # camera on the right side of the head
        br = min(right + pad_h, w)
        bb = min(bt + crop, h)
        bl = max(br - crop, 0)
        bt = bb - crop
        br = bl + crop
    else:
        bl = max(left - pad_h, 0)
        bb = min(bt + crop, h)
        br = min(bl + crop, w)
        bt = bb - crop
        bl = br - crop
    return bt, bb, bl, br


def process_subject(
    in_subject: Path,
    out_subject: Path,
    rt_scale_dict: Path,
    crop_out: int = 256,
    padding_v: float = 0.01,
    padding_h: float = 0.05,
    save_bilinear_vertices: bool = False,
):
    import cv2

    align = json.loads(Path(rt_scale_dict).read_text())
    s_idx = in_subject.name
    pose_dirs = sorted(
        d for d in in_subject.iterdir() if d.is_dir() and d.name[0].isdigit()
    )
    for pose_dir in pose_dirs:
        p_idx = pose_dir.name.split("_")[0]
        cam_dict = json.loads((pose_dir / "params.json").read_text())
        n_cams = 0
        while f"{n_cams}_Rt" in cam_dict:
            n_cams += 1
        extr = homogeneous(
            np.asarray([cam_dict[f"{i}_Rt"] for i in range(n_cams)], np.float64)
        )

        verts, faces = load_mesh(pose_dir.parent / (pose_dir.name + ".ply"))
        bilinear_verts = None
        reg_obj = pose_dir.parent / "models_reg" / (pose_dir.name + ".obj")
        if save_bilinear_vertices and reg_obj.is_file():
            bilinear_verts = load_obj(reg_obj)[0]

        # world alignment: scale, Rt_align with CAPSTUDIO axes, mm -> m
        scale = align[s_idx][p_idx][0]
        Rt_align = homogeneous(np.asarray(align[s_idx][p_idx][1], np.float64)[None])[0]
        Rt_align[:3] = FACESCAPE_2_CAPSTUDIO @ Rt_align[:3]
        poses = invert_rt(extr)
        poses[:, :3, 3] *= scale
        poses = Rt_align[None] @ poses
        poses[:, :3, 3] /= 1000.0
        extr = invert_rt(poses)
        verts = (verts * scale) @ Rt_align[:3, :3].T + Rt_align[:3, 3]
        verts /= 1000.0

        out_scan = out_subject / f"{int(p_idx):02d}"
        cam_out = {}
        for i in range(n_cams):
            if not cam_dict.get(f"{i}_valid", False):
                continue
            Rt = extr[i, :3]
            angles = camera_angles(Rt)
            if abs(angles["azimuth"]) > 90:
                continue
            img_path = pose_dir / f"{i}.jpg"
            if not img_path.is_file():
                img_path = pose_dir / f"{i}.png"
                if not img_path.is_file():
                    continue
            K = np.asarray(cam_dict[f"{i}_K"], np.float64)
            dist = np.asarray(cam_dict[f"{i}_distortion"], np.float64)
            w = cam_dict[f"{i}_width"]
            h = cam_dict[f"{i}_height"]

            rgb = cv2.imread(str(img_path))
            rgb = cv2.undistort(rgb, K, dist)
            depth = render_depth_cv(verts, faces, K, Rt, (h, w))
            mask = depth > 0
            if not mask.any():
                continue

            bt, bb, bl, br = side_aware_crop(
                mask, poses[i], h, w, padding_v, padding_h
            )
            rgb = rgb[bt:bb, bl:br]
            mask = mask[bt:bb, bl:br]
            K = K.copy()
            K[0, 2] -= bl
            K[1, 2] -= bt

            crop_in = min(h, w)
            rgb = cv2.resize(rgb, (crop_out, crop_out), interpolation=cv2.INTER_AREA)
            mask = cv2.resize(
                mask.astype(np.uint8), (crop_out, crop_out),
                interpolation=cv2.INTER_NEAREST,
            ).astype(bool)
            K[:2] *= crop_out / crop_in

            rgba = np.concatenate(
                [rgb, (mask[..., None] * 255).astype(np.uint8)], axis=-1
            )
            view_dir = out_scan / f"view_{i:05d}"
            view_dir.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(view_dir / "rgba.png"), rgba)
            cam_out[i] = dict(
                intrinsics=K.tolist(), extrinsics=Rt.tolist(), angles=angles
            )

        out_scan.mkdir(parents=True, exist_ok=True)
        (out_scan / "cameras.json").write_text(json.dumps(cam_out))
        if bilinear_verts is not None:
            np.savetxt(out_scan / "face_vertices.npy", bilinear_verts)

        calibrate_colors(out_scan, verts, faces)
        for f in out_scan.glob("view_*/rgba.png"):
            f.unlink()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dir_in", type=Path, required=True)
    p.add_argument("--dir_out", type=Path, required=True)
    p.add_argument("--rt_scale_dict", type=Path,
                   default=Path("assets/Rt_scale_dict.json"))
    p.add_argument("--crop_out", type=int, default=256)
    p.add_argument("--padding_v", type=float, default=0.01)
    p.add_argument("--padding_h", type=float, default=0.05)
    p.add_argument("--save_bilinear_vertices", action="store_true")
    args = p.parse_args(argv)
    args.dir_out.mkdir(parents=True, exist_ok=True)
    process_subject(
        args.dir_in, args.dir_out, args.rt_scale_dict, args.crop_out,
        args.padding_v, args.padding_h, args.save_bilinear_vertices,
    )


if __name__ == "__main__":
    main()
