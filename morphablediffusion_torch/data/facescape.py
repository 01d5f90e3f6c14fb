"""FaceScape dataset (perspective, FLAME/bilinear face meshes).

The PyTorch port's own copy of the JAX package's `data/facescape.py`: the
reference's directory layout
(<data_dir>/<subject>/<expression>/view_XXXXX/rgba_colorcalib.png +
cameras.json), splits (train subjects 001-325 minus 122/212, test
122/212/326-359, held-out expression '06'), view-sampling rules (target
azimuth <= 90 deg with a non-flipped roll, input azimuth <= 40 deg, from
another random expression when shuffled_expression) and camera/vertex axis
conventions. Vertices are padded to a static count with a mask. scipy is
imported only where a camera's roll is read.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List

import numpy as np

from morphablediffusion_torch.data.common import load_rgba_white, pad_vertices
from morphablediffusion_torch.utils.mesh_io import load_mesh_vertices

CAPSTUDIO_2_FACESCAPE = np.asarray(
    [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], dtype=np.float64
)
FACESCAPE_2_CAPSTUDIO = np.asarray(
    [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], dtype=np.float64
)
WORLD_SCALE = 2.5
HELDOUT_EXPRESSIONS = ("06",)
TEST_SUBJECTS = ("122", "212") + tuple(str(i) for i in range(326, 360))


def train_val_uids():
    """(train_uids, val_uids) as 'subject/expression' strings (facescape.py:200-212)."""
    train_subjects = [str(i).zfill(3) for i in range(1, 326)]
    for s in ("122", "212"):
        train_subjects.remove(s)
    train_exps = [str(i).zfill(2) for i in range(1, 21)]
    for e in HELDOUT_EXPRESSIONS:
        train_exps.remove(e)
    train = [f"{s}/{e}" for s in train_subjects for e in train_exps]
    val = [f"{s}/{e}" for s in TEST_SUBJECTS for e in HELDOUT_EXPRESSIONS]
    return train, val


class FaceScapeDataset:
    """Map-style dataset; __getitem__ returns the static-shape item dict."""

    def __init__(
        self,
        data_dir: str,
        uids: List[str],
        mesh_topology: str = "flame",
        shuffled_expression: bool = True,
        image_size: int = 256,
        num_views: int = 16,
        max_vertices: int = 5120,
        flame_assets_dir: str = "./assets/facescape_flame_tracking",
        seed: int = 0,
        max_retries: int = 32,
    ):
        self.data_dir = Path(data_dir)
        self.uids = list(uids)
        self.mesh_topology = mesh_topology
        self.shuffled_expression = shuffled_expression
        self.image_size = image_size
        self.num_views = num_views
        self.max_vertices = max_vertices
        self.flame_assets_dir = Path(flame_assets_dir)
        self.rng = random.Random(seed)
        self.max_retries = max_retries

    def __len__(self):
        return len(self.uids)

    # ------------------------------------------------------------------ #

    def _valid_views(self, data_dir: Path, camera_dict: dict) -> List[str]:
        """Views that exist on disk and whose roll is not upside-down
        (facescape.py:109-116)."""
        from scipy.spatial.transform import Rotation  # only reading cameras needs scipy

        out = []
        for view, cam in camera_dict.items():
            RT = np.asarray(cam["extrinsics"])
            roll = Rotation.from_matrix(RT[:3, :3]).as_euler("xyz", degrees=True)[-1]
            if abs(roll) > 90:
                continue
            if (data_dir / f"view_{str(view).zfill(5)}" / "rgba_colorcalib.png").is_file():
                out.append(view)
        return out

    def _load_view(self, data_dir: Path, view: str):
        return load_rgba_white(
            data_dir / f"view_{str(view).zfill(5)}" / "rgba_colorcalib.png",
            self.image_size,
        )

    @staticmethod
    def _camera(camera_dict: dict, view: str):
        """(K 4x4, RT 3x4) in the model's world convention (facescape.py:150-154)."""
        K = np.eye(4, dtype=np.float64)
        K[:3, :3] = np.asarray(camera_dict[view]["intrinsics"])
        RT = np.asarray(camera_dict[view]["extrinsics"], dtype=np.float64)[:3]
        RT = RT.copy()
        RT[:3, 3] *= WORLD_SCALE
        RT[:3, :3] = RT[:3, :3] @ FACESCAPE_2_CAPSTUDIO
        return K.astype(np.float32), RT.astype(np.float32)

    def _input_view(self, subject: str, expression: str):
        """Pick the input view, optionally from a different expression
        (facescape.py:66-98)."""
        if self.shuffled_expression:
            candidates = [
                e for e in (str(i).zfill(2) for i in range(1, 21))
                if e not in HELDOUT_EXPRESSIONS
                and e != expression
                and (self.data_dir / subject / e / "cameras.json").is_file()
            ]
            exp_id = self.rng.choice(candidates) if candidates else expression
        else:
            exp_id = expression
        data_dir = self.data_dir / subject / exp_id
        camera_dict = json.loads((data_dir / "cameras.json").read_text())
        valid = self._valid_views(data_dir, camera_dict)
        frontal = [
            v for v in valid if abs(camera_dict[v]["angles"]["azimuth"]) <= 40
        ]
        view = self.rng.choice(frontal)
        K, RT = self._camera(camera_dict, view)
        return self._load_view(data_dir, view), K, RT

    def _vertices(self, subject: str, expression: str) -> np.ndarray:
        """World-space mesh vertices (facescape.py:125-130)."""
        if self.mesh_topology == "bilinear":
            v = WORLD_SCALE * np.loadtxt(
                self.data_dir / subject / expression / "face_vertices.npy"
            )
        elif self.mesh_topology == "flame":
            v = WORLD_SCALE * load_mesh_vertices(
                self.flame_assets_dir / subject / expression / "mesh.obj"
            )
        else:
            raise NotImplementedError(self.mesh_topology)
        return (CAPSTUDIO_2_FACESCAPE @ v.T).T.astype(np.float32)

    # ------------------------------------------------------------------ #

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        last_err = None
        for _ in range(self.max_retries):
            try:
                return self._item(self.uids[index])
            except Exception as e:  # corrupted sample: resample (facescape.py:135-137)
                last_err = e
                index = self.rng.randrange(len(self.uids))
        raise RuntimeError(f"facescape: {self.max_retries} retries failed") from last_err

    def _item(self, uid: str) -> Dict[str, np.ndarray]:
        subject, expression = uid.split("/")
        data_dir = self.data_dir / uid
        camera_dict = json.loads((data_dir / "cameras.json").read_text())
        valid = self._valid_views(data_dir, camera_dict)
        targets = [
            v for v in valid if abs(camera_dict[v]["angles"]["azimuth"]) <= 90
        ]
        target_views = self.rng.sample(targets, self.num_views)

        input_img, input_K, input_RT = self._input_view(subject, expression)
        verts, mask = pad_vertices(
            self._vertices(subject, expression), self.max_vertices
        )

        imgs, Ks, RTs = [], [], []
        for v in target_views:
            imgs.append(self._load_view(data_dir, v))
            K, RT = self._camera(camera_dict, v)
            Ks.append(K)
            RTs.append(RT)

        N = self.num_views
        return {
            "target_image": np.stack(imgs).astype(np.float32),
            "input_image": input_img,
            "input_elevation": np.zeros((1,), np.float32),
            "input_azimuth": np.zeros((1,), np.float32),
            "target_elevation": np.zeros((N,), np.float32),
            "target_azimuth": np.zeros((N,), np.float32),
            "input_K": input_K,
            "input_RT": input_RT,
            "target_K": np.stack(Ks).astype(np.float32),
            "target_RT": np.stack(RTs).astype(np.float32),
            "vertices": verts,
            "vertex_mask": mask,
        }
