"""The one traffic generator: batches of the model's inputs from a traffic
file's parameters, a configuration and a seed.

A batch (the model's layout) holds B portraits: an input image in [-1, 1],
a ring of `view_num` cameras at `distance_m` looking at the origin, and a
head mesh. The mesh is FLAME-sized: `vertices` points spread evenly over an
ellipsoid of the given semi-axes (a closed head-sized surface, so that the
occupied fine voxels form a shell as a face's do), moved by the seed only
by a small offset of the whole and a small jitter of each point, and
padded with masked rows to the configuration's `max_vertices`. Training
batches also hold `view_num` target images. Every seed gives the same
shapes and the same masked vertex count; only values differ.

Values come from a `torch.Generator` on the device, seeded from (seed,
stream, index), in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK64 = (1 << 63) - 1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    """A generator seed for one stream of draws of a run (inputs, noise,
    weights), stable for any whole-number seed."""
    h = 1469598103934665603
    for ch in f"{seed}/{stream}/{index}".encode():
        h = ((h ^ ch) * 1099511628211) & MASK64
    return h


def generator(device, seed: int, stream: str, index: int = 0) -> torch.Generator:
    return torch.Generator(device).manual_seed(stream_seed(seed, stream, index))


def ring_cameras(n: int, size: int, cam: dict):
    """(K (n, 4, 4), RT (n, 3, 4)): a ring over `arc` of a full turn at
    `distance_m`, every camera looking at the origin, focal `focal_px` at
    the image's `size`."""
    rts = []
    for i in range(n):
        a = 2 * math.pi * i / n * cam["arc"]
        R = np.array([[math.cos(a), 0, -math.sin(a)], [0, 1, 0], [math.sin(a), 0, math.cos(a)]])
        t = -R @ (R.T @ np.array([0.0, 0.0, -cam["distance_m"]]))
        rts.append(np.concatenate([R, t[:, None]], 1))
    K = np.eye(4)
    K[:3, :3] = [[cam["focal_px"], 0, size / 2], [0, cam["focal_px"], size / 2], [0, 0, 1]]
    return np.broadcast_to(K, (n, 4, 4)), np.stack(rts)


def head_surface(head: dict) -> np.ndarray:
    """(n, 3) points spread evenly (a Fibonacci lattice) over the ellipsoid
    of semi-axes `semi_axes_m`, in metres."""
    n = head["vertices"]
    i = np.arange(n) + 0.5
    z = 1 - 2 * i / n
    r = np.sqrt(1 - z * z)
    phi = math.pi * (3 - math.sqrt(5)) * i
    unit = np.stack([r * np.cos(phi), z, r * np.sin(phi)], 1)  # y up
    return unit * np.asarray(head["semi_axes_m"])


class BatchMaker:
    """Batches of a run: the cameras and the head surface, the same in every
    batch, are put on the device once; each batch then takes its values
    from a device generator, with no copy from the host."""

    def __init__(self, model_cfg: dict, traffic: dict, seed: int, device):
        self.B, self.N = traffic["batch"], model_cfg["view_num"]
        self.S, self.Nv = model_cfg["image_size"], model_cfg["max_vertices"]
        self.traffic, self.seed, self.device = traffic, seed, device
        head = traffic["head"]
        if head["vertices"] > self.Nv:
            raise ValueError(f"{head['vertices']} vertices do not fit max_vertices {self.Nv}")
        f32 = dict(device=device, dtype=torch.float32)
        K, RT = ring_cameras(self.N, self.S, traffic["cameras"])
        self.K = torch.as_tensor(np.ascontiguousarray(K), **f32)
        self.RT = torch.as_tensor(RT, **f32)
        self.base = torch.as_tensor(head_surface(head), **f32)
        self.mask = torch.zeros((self.B, self.Nv), **f32)
        self.mask[:, :self.base.shape[0]] = 1.0

    def __call__(self, index: int, with_targets: bool = False):
        """Batch `index`: a dict of float32 tensors in the model's layout."""
        B, N, S, Nv, t = self.B, self.N, self.S, self.Nv, self.traffic
        g = generator(self.device, self.seed, "inputs", index)
        lo, hi = t["images"]["low"], t["images"]["high"]
        f32 = dict(device=self.device, dtype=torch.float32)
        n = self.base.shape[0]
        jitter = torch.randn((B, n, 3), generator=g, **f32) * t["head"]["jitter_m"]
        offset = (torch.rand((B, 1, 3), generator=g, **f32) * 2 - 1) * t["head"]["offset_m"]
        verts = torch.zeros((B, Nv, 3), **f32)
        verts[:, :n] = self.base + jitter + offset
        batch = {
            "input_image": torch.rand((B, S, S, 3), generator=g, **f32) * (hi - lo) + lo,
            "input_elevation": torch.zeros((B, 1), **f32),
            "input_azimuth": torch.zeros((B, 1), **f32),
            "target_elevation": torch.zeros((B, N), **f32),
            "target_azimuth": torch.zeros((B, N), **f32),
            "target_K": self.K.expand(B, N, 4, 4).contiguous(),
            "target_RT": self.RT.expand(B, N, 3, 4).contiguous(),
            "vertices": verts,
            "vertex_mask": self.mask.clone(),
        }
        if with_targets:
            batch["target_image"] = (torch.rand((B, N, S, S, 3), generator=g, **f32)
                                     * (hi - lo) + lo)
        return batch


def make_batch(model_cfg: dict, traffic: dict, seed: int, index: int, device,
               with_targets: bool = False):
    """Batch `index` of a run with `seed` (see BatchMaker)."""
    return BatchMaker(model_cfg, traffic, seed, device)(index, with_targets)


def training_draws(model_cfg: dict, B: int, seed: int, index: int, device,
                   num_timesteps: int = 1000):
    """The random inputs of training step `index`: the VAE posterior draws of
    the targets (B*N, h, w, 4) and of the input view (B, h, w, 4) in the
    compute dtype, the timesteps (B,), the noise (B, N, h, w, 4), the target
    view (B, 1) and the condition-drop uniforms (B,)."""
    g = generator(device, seed, "draws", index)
    N, h = model_cfg["view_num"], model_cfg["image_size"] // 8
    dt = DTYPES[model_cfg["dtype"]]
    normal = lambda *s, dtype=torch.float32: torch.randn(s, generator=g, device=device,
                                                         dtype=dtype)
    return {
        "vae_target": normal(B * N, h, h, 4, dtype=dt),
        "vae_input": normal(B, h, h, 4, dtype=dt),
        "t": torch.randint(0, num_timesteps, (B,), generator=g, device=device),
        "noise": normal(B, N, h, h, 4),
        "target_index": torch.randint(0, N, (B, 1), generator=g, device=device),
        "r": torch.rand((B,), generator=g, device=device),
    }


def occupied_fine_voxels(batch, voxel: float) -> int:
    """Occupied cells of the fine grid over the batch: distinct voxel
    indices of the masked vertices relative to each sample's minimum."""
    total = 0
    for v, m in zip(batch["vertices"], batch["vertex_mask"]):
        dhw = v[m > 0].flip(-1)
        idx = torch.round((dhw - dhw.amin(0)) / voxel).long()
        total += int(torch.unique(idx, dim=0).shape[0])
    return total
