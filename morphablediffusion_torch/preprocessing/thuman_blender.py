"""Blender render script for THuman 2.1 (runs inside Blender).

The PyTorch port's own copy of the JAX package's
`preprocessing/thuman_blender.py`, whole; it needs no PyTorch.

Same contract as the reference's preprocessing/thuman/blender_script.py:
an orthographic camera (ortho_scale 1.2, distance 1.5, 256x256 RGBA film)
orbits the normalized scan at 16 evenly-spaced azimuths. Two passes per
scan:

  * camera_type=fixed  -> fixed elevation (default 0 deg) -> `target/<uid>/`
  * camera_type=random -> per-view elevation in [-20, 20] deg ->
    `input/<uid>/` + `meta.pkl` = [K, azimuths, elevations, distances,
    poses (N, 3, 4)]

plus `<output>/../normalization/<uid>.npy` = [scale, ox, oy, oz] from the
SMPL-X stats (thuman_smplx_scale.py output), applied so the body fits a
1.2-unit ortho frame at the world origin.

Usage:
    blender -b -P thuman_blender.py -- --object_path scan/<uid>/<uid>.obj \
        --output_dir renders/target --camera_type fixed \
        --smplx_stats_path smplx_stats/<uid>.npy
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import sys
from pathlib import Path

import numpy as np

try:
    import bpy
    from mathutils import Matrix, Vector
except ImportError:  # imported outside Blender (e.g. by tests): API only
    bpy = None


def spherical_to_cartesian(azimuths, elevations, distance):
    """(N, 3) points; `distance` a scalar or one per view (main() passes
    one per view, which the JAX package's copy cannot broadcast)."""
    x = np.cos(azimuths) * np.cos(elevations)
    y = np.sin(azimuths) * np.cos(elevations)
    z = np.sin(elevations)
    d = np.asarray(distance)
    return np.stack([x, y, z], axis=-1) * (d[..., None] if d.ndim else distance)


def camera_poses_for(azimuths, elevations, distances):
    """cv-convention world->cam (N, 3, 4) for cameras looking at the origin
    with +z world as up."""
    pts = spherical_to_cartesian(azimuths, elevations, distances)
    poses = []
    for eye in pts:
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)
        t = -R @ eye
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    return np.stack(poses).astype(np.float32)


def _parse_args():
    argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else sys.argv[1:]
    p = argparse.ArgumentParser()
    p.add_argument("--object_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--engine", default="CYCLES", choices=["CYCLES", "BLENDER_EEVEE"])
    p.add_argument("--camera_type", default="fixed", choices=["fixed", "random"])
    p.add_argument("--num_images", type=int, default=16)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--elevation_start", type=float, default=-20.0)
    p.add_argument("--elevation_end", type=float, default=20.0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--ortho_scale", type=float, default=1.2)
    p.add_argument("--camera_dist", type=float, default=1.5)
    p.add_argument("--smplx_stats_path", required=True)
    return p.parse_args(argv)


def _setup_scene(args):
    scene = bpy.context.scene
    render = scene.render
    render.engine = args.engine
    render.image_settings.file_format = "PNG"
    render.image_settings.color_mode = "RGBA"
    render.resolution_x = render.resolution_y = args.resolution
    render.film_transparent = True
    scene.cycles.samples = 64

    cam = scene.objects["Camera"]
    cam.data.type = "ORTHO"
    cam.data.ortho_scale = args.ortho_scale
    constraint = cam.constraints.new(type="TRACK_TO")
    constraint.track_axis = "TRACK_NEGATIVE_Z"
    constraint.up_axis = "UP_Y"

    world = scene.world.node_tree.nodes["Background"]
    world.inputs["Color"].default_value = Vector([0.7, 0.7, 0.7, 1.0])
    world.inputs["Strength"].default_value = 1.0
    return scene, cam, constraint


def _reset_and_load(object_path):
    for obj in list(bpy.context.scene.objects):
        if obj.type not in ("CAMERA", "LIGHT"):
            bpy.data.objects.remove(obj, do_unlink=True)
    ext = Path(object_path).suffix.lower()
    if ext == ".obj":
        bpy.ops.import_scene.obj(filepath=str(object_path))
    elif ext in (".glb", ".gltf"):
        bpy.ops.import_scene.gltf(filepath=str(object_path))
    elif ext == ".ply":
        bpy.ops.import_mesh.ply(filepath=str(object_path))
    else:
        raise ValueError(f"unsupported scan format {ext}")


def _normalize_scene(scale, center):
    """Scale the scan and move its centroid to the origin; returns offset."""
    offset = -np.asarray(center) * scale
    for obj in bpy.context.scene.objects:
        if obj.type == "MESH":
            obj.scale = (scale, scale, scale)
            obj.location = Vector(offset.tolist())
    bpy.context.view_layer.update()
    return offset


def _blender_rt(cam):
    """cv-convention world->cam (3, 4) from Blender's camera matrix."""
    m = np.asarray(cam.matrix_world.inverted())
    flip = np.diag([1.0, -1.0, -1.0])  # Blender cam looks -z, cv looks +z
    R = flip @ m[:3, :3]
    t = flip @ m[:3, 3]
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def main():
    args = _parse_args()
    if bpy is None:
        raise SystemExit("thuman_blender.py must run inside blender -b -P")
    uid = Path(args.object_path).parent.name or Path(args.object_path).stem
    out_dir = Path(args.output_dir) / uid
    out_dir.mkdir(parents=True, exist_ok=True)

    stats = np.load(args.smplx_stats_path)
    scale, center = float(stats[0]), stats[1:4]

    scene, cam, constraint = _setup_scene(args)
    _reset_and_load(args.object_path)
    offset = _normalize_scene(scale, center)
    norm_dir = Path(args.output_dir).parent / "normalization"
    norm_dir.mkdir(parents=True, exist_ok=True)
    np.save(norm_dir / f"{uid}.npy", np.asarray([scale, *offset], np.float32))

    empty = bpy.data.objects.new("Empty", None)
    scene.collection.objects.link(empty)
    constraint.target = empty

    n = args.num_images
    azimuths = (np.arange(n) / n * 2 * np.pi).astype(np.float32)
    if args.camera_type == "fixed":
        elevations = np.deg2rad(np.full(n, args.elevation, np.float32))
    else:
        elevations = np.deg2rad(
            np.random.uniform(args.elevation_start, args.elevation_end, n)
        ).astype(np.float32)
    distances = np.full(n, args.camera_dist, np.float32)
    pts = spherical_to_cartesian(azimuths, elevations, distances)

    poses = []
    for i in range(n):
        cam.location = Vector(pts[i].tolist())
        bpy.context.view_layer.update()
        poses.append(_blender_rt(cam))
        render_path = out_dir / f"{i:03d}.png"
        if render_path.exists():
            continue
        scene.render.filepath = str(render_path.resolve())
        bpy.ops.render.render(write_still=True)

    if args.camera_type == "random":
        K = np.asarray(
            cam.calc_matrix_camera(
                bpy.context.evaluated_depsgraph_get(),
                x=scene.render.resolution_x,
                y=scene.render.resolution_y,
                scale_x=scene.render.pixel_aspect_x,
                scale_y=scene.render.pixel_aspect_y,
            )
        )
        with open(out_dir / "meta.pkl", "wb") as f:
            pickle.dump([K, azimuths, elevations, distances, np.stack(poses)], f)


if __name__ == "__main__":
    main()
