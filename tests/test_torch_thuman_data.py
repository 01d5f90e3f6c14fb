"""The port's THuman data pipeline and its train CLI on a synthetic on-disk
layout (the fixture of tests/test_data.py::thuman_root, with a second scan
at uid 600 so that both axis conventions are read), on the CPU. The
dataset and the loader yield the JAX package's arrays exactly; the CLI
takes a training step with `--device cpu`, reading the shared cameras from
`./assets/thuman_meta.pkl` of its working directory."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

from morphablediffusion_torch.data.loader import PrefetchLoader as TLoader
from morphablediffusion_torch.data.thuman import THumanDataset as TDataset
from morphablediffusion_tpu.data.loader import PrefetchLoader as JLoader
from morphablediffusion_tpu.data.thuman import THumanDataset as JDataset
from tests.test_data import _write_obj, _write_rgba
from tests.test_torch_train_cli import TRAIN_YAML

UIDS = [1, 600]  # before and after 526: the Blender rotation and none


def _thuman_layout(root: Path):
    """tests/test_data.py::thuman_root for each of UIDS: 16 target and 16
    input views of 32^2, the scan's meta.pkl and normalization, a 20-vertex
    SMPL-X mesh; the shared cameras in root/assets/thuman_meta.pkl."""
    data, smplx = root / "thuman", root / "smplx"
    K = np.asarray([[1 / 0.6, 0, 0], [0, 1 / 0.6, 0], [0, 0, 1]], np.float32)
    poses = np.stack([np.concatenate([np.eye(3), [[0], [0], [1.5]]], 1)
                      for _ in range(16)]).astype(np.float32)
    meta = (K, np.zeros(16), np.zeros(16), np.zeros(16), poses)
    (root / "assets").mkdir(parents=True)
    (root / "assets" / "thuman_meta.pkl").write_bytes(pickle.dumps(meta))
    (data / "normalization").mkdir(parents=True)
    for i, uid_int in enumerate(UIDS):
        uid = str(uid_int).zfill(4)
        for v in range(16):
            _write_rgba(data / "target" / uid / f"{str(v).zfill(3)}.png", seed=v + 50 * i)
            _write_rgba(data / "input" / uid / f"{str(v).zfill(3)}.png", seed=100 + v + 50 * i)
        (data / "input" / uid / "meta.pkl").write_bytes(pickle.dumps(meta))
        np.save(data / "normalization" / f"{uid}.npy",
                np.asarray([0.5, 0.0, 0.1, 0.0], np.float32))
        _write_obj(smplx / uid / "mesh_smplx.obj", n=20, seed=i)
    return data, smplx, root / "assets" / "thuman_meta.pkl"


def test_dataset_and_loader_match_jax(tmp_path):
    data, smplx, meta = _thuman_layout(tmp_path)
    kw = dict(image_size=32, num_views=16, max_vertices=32, meta_pkl=str(meta), seed=3)
    jds, tds = JDataset(str(data), str(smplx), UIDS, **kw), TDataset(str(data), str(smplx),
                                                                     UIDS, **kw)
    for _ in range(2):  # the second pass draws other views from the same rng
        for i in range(len(UIDS)):
            a, b = jds[i], tds[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(tds[0]["vertices"], tds[1]["vertices"])
    kw["seed"] = 4
    jit = JLoader(JDataset(str(data), str(smplx), UIDS, **kw), 2, seed=1, num_workers=1).epochs()
    tit = TLoader(TDataset(str(data), str(smplx), UIDS, **kw), 2, seed=1, num_workers=1).epochs()
    try:
        for _ in range(3):
            a, b = next(jit), next(tit)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        jit.close()
        tit.close()


def test_train_cli_reads_thuman(tmp_path):
    """One step of the port's train CLI with --device cpu on the THuman
    layout (orthographic cameras), its validation sheet and checkpoint."""
    data, smplx, _ = _thuman_layout(tmp_path)
    cfg = tmp_path / "thuman.yaml"
    cfg.write_text(TRAIN_YAML.replace("  dtype: float32\n", "  dtype: float32\n"
                                      "  projection: orthographic\n").replace(
        "  dataset: facescape\n",
        f"  dataset: thuman\n  data_dir: {data}\n  smplx_dir: {smplx}\n"
        f"  uids: {UIDS}\n  val_uids: [600]\n"))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "morphablediffusion_torch.apps.train", "-b", str(cfg), "-l",
         str(tmp_path / "runs"), "-n", "thuman", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=180, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 1 loss" in r.stdout and "training done" in r.stdout
    run_dir = tmp_path / "runs" / "thuman"
    assert (run_dir / "ckpt" / "last" / "state.pt").is_file()
    assert (run_dir / "images" / "val" / "1.jpg").is_file()
