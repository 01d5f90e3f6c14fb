"""THuman 2.1 dataset (orthographic, SMPL-X body meshes).

The PyTorch port's own copy of the JAX package's `data/thuman.py`: 16 fixed
orthographic target views whose shared cameras come from
`assets/thuman_meta.pkl` (resolved from the working directory, as the train
CLI leaves it), a random input view with the scan's own `meta.pkl`, SMPL-X
vertices from `mesh_smplx.obj` with the Blender axis rotation of scans
before 526 and the scan's scale/offset normalization. Splits: train 0-2200,
val 2201-2444. The view draws use `random.Random(seed)` in the JAX order,
so that both packages yield equal items.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List

import numpy as np

from morphablediffusion_torch.data.common import load_rgba_white, pad_vertices
from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices, read_pickle

# applied to the vertices of scans with uid < 526
ROT_BLENDER = np.asarray([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=np.float64)


def train_val_uids():
    return list(range(2201)), list(range(2201, 2445))


class THumanDataset:
    def __init__(
        self,
        data_dir: str,
        smplx_dir: str,
        uids: List[int],
        image_size: int = 256,
        num_views: int = 16,
        max_vertices: int = 10496,
        meta_pkl: str = "./assets/thuman_meta.pkl",
        seed: int = 0,
        max_retries: int = 32,
    ):
        self.data_dir = Path(data_dir)
        self.smplx_dir = Path(smplx_dir)
        self.uids = list(uids)
        self.image_size = image_size
        self.num_views = num_views
        self.max_vertices = max_vertices
        self.rng = random.Random(seed)
        self.max_retries = max_retries
        # shared orthographic target cameras: (K, azimuths, elevations,
        # distances, poses)
        K, _, _, _, poses = read_pickle(meta_pkl)
        self.target_K = np.asarray(K, dtype=np.float32)
        self.target_poses = np.asarray(poses, dtype=np.float32)

    def __len__(self):
        return len(self.uids)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        """The item of uids[index]; an item that fails to load is replaced
        by a random other one, up to max_retries times."""
        last_err = None
        for _ in range(self.max_retries):
            try:
                return self._item(self.uids[index])
            except Exception as e:  # a missing or corrupt file of one scan
                last_err = e
                index = self.rng.randrange(len(self.uids))
        raise RuntimeError(f"thuman: {self.max_retries} retries failed") from last_err

    @staticmethod
    def _pad_K(K) -> np.ndarray:
        K4 = np.eye(4, dtype=np.float32)
        K = np.asarray(K, dtype=np.float32)
        K4[: K.shape[0], : K.shape[1]] = K
        return K4

    def _item(self, uid_int: int) -> Dict[str, np.ndarray]:
        uid = str(uid_int).zfill(4)
        views = list(range(self.num_views))
        self.rng.shuffle(views)

        imgs, Ks, RTs = [], [], []
        for v in views:
            imgs.append(load_rgba_white(
                self.data_dir / "target" / uid / f"{str(v).zfill(3)}.png", self.image_size))
            Ks.append(self._pad_K(self.target_K))
            RTs.append(np.asarray(self.target_poses[v], np.float32)[:3])

        input_view = self.rng.randint(0, self.num_views - 1)
        input_img = load_rgba_white(
            self.data_dir / "input" / uid / f"{str(input_view).zfill(3)}.png", self.image_size)
        input_K, _, _, _, input_poses = read_pickle(self.data_dir / "input" / uid / "meta.pkl")
        input_RT = np.asarray(input_poses[input_view], np.float32)[:3]

        rot = np.eye(3) if uid_int >= 526 else ROT_BLENDER
        v = load_mesh_vertices(self.smplx_dir / uid / "mesh_smplx.obj")
        v = (rot @ v.T).T
        norm = np.asarray(
            np.load(self.data_dir / "normalization" / f"{uid}.npy", allow_pickle=True),
            dtype=np.float32)
        v = v * norm[0] + norm[1:]
        verts, mask = pad_vertices(v.astype(np.float32), self.max_vertices)

        N = self.num_views
        return {
            "target_image": np.stack(imgs).astype(np.float32),
            "input_image": input_img,
            "input_elevation": np.zeros((1,), np.float32),
            "input_azimuth": np.zeros((1,), np.float32),
            "target_elevation": np.zeros((N,), np.float32),
            "target_azimuth": np.zeros((N,), np.float32),
            "input_K": self._pad_K(input_K),
            "input_RT": input_RT,
            "target_K": np.stack(Ks),
            "target_RT": np.stack(RTs),
            "vertices": verts,
            "vertex_mask": mask,
        }
