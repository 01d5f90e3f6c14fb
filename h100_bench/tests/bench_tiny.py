"""A tiny configuration and traffic for running the harness on the CPU:
the repository's tiny test model (64^2 images, 4 views, UNet width 32, a
2-layer CLIP, float32) with both conditioners, 2 DDIM steps."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(mode: str = "coarse") -> dict:
    doc = json.loads((BENCH / "configs" / "facescape_coarse.json").read_text())
    m = doc["model"]
    m.update(view_num=4, image_size=64, spatial_volume_size=8, frustum_volume_depth=8,
             voxel_grid_shape=[16, 16, 16], max_vertices=640, sample_steps=2,
             dtype="float32", vae_ch=32, vae_ch_mult=[1, 1, 1, 1], vae_num_res_blocks=1,
             mesh_voxel_mode=mode, fine_grid_shape=[64, 64, 64])
    m["unet"].update(model_channels=32, num_heads=4, volume_dims=[8, 16, 32, 64],
                     use_checkpoint=False)
    m["clip"].update(width=64, layers=2, num_heads=2)
    doc["sampler"]["steps"] = 2
    return doc


def traffic(name: str) -> dict:
    t = copy.deepcopy(json.loads((BENCH / "traffic" / f"{name}.json").read_text()))
    t["batch"] = 2
    t["head"]["vertices"] = 600
    t["check"]["steps"] = min(t["check"]["steps"], 2)
    if "pool" in t:
        t["pool"] = 3
    return t
