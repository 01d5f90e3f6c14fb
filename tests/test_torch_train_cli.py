"""The port's FaceScape data pipeline and its train CLI on a synthetic
on-disk layout (as tests/test_cli_integration.py::test_train_cli makes
one), on the CPU. The dataset and the loader yield the JAX package's arrays
exactly; the CLI takes a training step with `--device cpu`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from morphablediffusion_torch.data.facescape import FaceScapeDataset as TDataset
from morphablediffusion_torch.data.loader import PrefetchLoader as TLoader
from morphablediffusion_tpu.data.facescape import FaceScapeDataset as JDataset
from morphablediffusion_tpu.data.loader import PrefetchLoader as JLoader


def _facescape_layout(root):
    """Synthetic on-disk FaceScape layout: 2 subjects x 2 expressions x 4
    views of 64^2 RGBA, cameras.json, and tracked FLAME meshes (as in
    tests/test_cli_integration.py::test_train_cli)."""
    data, flame = root / "data", root / "flame"
    rng = np.random.default_rng(1)
    for s in ["001", "002"]:
        for e in ["01", "02"]:
            d = data / s / e
            cams = {}
            for v in range(4):
                p = d / f"view_{str(v).zfill(5)}" / "rgba_colorcalib.png"
                p.parent.mkdir(parents=True, exist_ok=True)
                a = rng.integers(0, 255, (64, 64, 4), dtype=np.uint8)
                a[..., 3] = 255
                Image.fromarray(a, "RGBA").save(p)
                cams[str(v)] = {
                    "intrinsics": [[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]],
                    "extrinsics": [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5]],
                    "angles": {"azimuth": (v - 2) * 20, "elevation": 0.0},
                }
            (d / "cameras.json").write_text(json.dumps(cams))
            m = flame / s / e / "mesh.obj"
            m.parent.mkdir(parents=True, exist_ok=True)
            m.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in rng.uniform(-0.1, 0.1, (12, 3))))
    return data, flame


UIDS = ["001/01", "001/02", "002/01", "002/02"]


def test_dataset_and_loader_match_jax(tmp_path):
    data, flame = _facescape_layout(tmp_path)
    kw = dict(mesh_topology="flame", shuffled_expression=True, image_size=64, num_views=2,
              max_vertices=64, flame_assets_dir=str(flame), seed=4)
    jds, tds = JDataset(str(data), UIDS, **kw), TDataset(str(data), UIDS, **kw)
    for i in range(len(UIDS)):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kw["seed"] = 5
    jit = JLoader(JDataset(str(data), UIDS, **kw), 2, seed=1, num_workers=1).epochs()
    tit = TLoader(TDataset(str(data), UIDS, **kw), 2, seed=1, num_workers=1).epochs()
    try:
        for _ in range(3):
            a, b = next(jit), next(tit)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        jit.close()
        tit.close()



TRAIN_YAML = """
model:
  view_num: 2
  image_size: 64
  spatial_volume_size: 8
  frustum_volume_depth: 8
  voxel_grid_shape: [16, 16, 16]
  max_vertices: 64
  sample_steps: 2
  output_num: 1
  dtype: float32
  vae_ch: 32
  vae_ch_mult: [1, 1, 1, 1]
  vae_num_res_blocks: 1
  unet:
    model_channels: 32
    num_heads: 4
    volume_dims: [8, 16, 32, 64]
  clip:
    width: 64
    layers: 2
    num_heads: 2
    patch_size: 14
    output_dim: 768
data:
  dataset: facescape
  batch_size: 2
  num_workers: 1
  shuffled_expression: false
train:
  max_steps: 1
  log_every: 1
  val_check_interval: 1
"""


def test_train_cli_on_the_cpu(tmp_path):
    """One step of the port's train CLI with --device cpu on the synthetic
    layout (step log, validation contact sheet, checkpoint), a rerun that is
    refused without --resume, a --vae_from file that is missing, and a
    resumed second step."""
    from morphablediffusion_torch.apps import train

    data, flame = _facescape_layout(tmp_path)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(TRAIN_YAML.replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {UIDS}\n  val_uids: ['002/02']\n"))
    args = ["-b", str(cfg), "-l", str(tmp_path / "runs"), "-n", "smoke", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="2")
    run = lambda *extra: subprocess.run(
        [sys.executable, "-m", "morphablediffusion_torch.apps.train", *args, *extra],
        capture_output=True, text=True, env=env, timeout=120)
    r = run()
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 1 loss" in r.stdout and "training done" in r.stdout
    assert " rss " in r.stdout
    run_dir = tmp_path / "runs" / "smoke"
    assert (run_dir / "ckpt" / "last" / "state.pt").is_file()
    assert Image.open(run_dir / "images" / "val" / "1.jpg").size == (64 * 3, 64)
    with pytest.raises(RuntimeError, match="--resume"):
        train.main(args)
    with pytest.raises(FileNotFoundError):  # a --vae_from path that is not there
        train.main(args + ["-n", "no_vae", "--vae_from", str(tmp_path / "missing.pt")])
    r = run("--resume", "--max_steps", "2")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 1" in r.stdout and "step 2 loss" in r.stdout


def test_rss_restart_resumes(tmp_path):
    """--rss_restart_gb near 0 with a rolling checkpoint every step: after
    step 1 the run saves, replaces itself with the same command plus
    --resume, resumes from step 1 and ends at max_steps."""
    data, flame = _facescape_layout(tmp_path)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(TRAIN_YAML.replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {UIDS}\n  val_uids: ['002/02']\n").replace(
        "  val_check_interval: 1\n", "  val_check_interval: 0\n"
        "  rolling_checkpoint_every: 1\n"))
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "morphablediffusion_torch.apps.train", "-b", str(cfg), "-l",
         str(tmp_path / "runs"), "-n", "rss", "--device", "cpu", "--max_steps", "2",
         "--rss_restart_gb", "0.001"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "GiB: self-restarting with --resume at step 1" in out
    assert "resumed from step 1" in out and "step 2 loss" in out
    assert out.rstrip().endswith("training done") and out.count("training done") == 1
    assert (tmp_path / "runs" / "rss" / "ckpt" / "last" / "step").read_text() == "2"
