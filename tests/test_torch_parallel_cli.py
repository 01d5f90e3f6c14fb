"""The port on more than one rank through its entry points, on the CPU:

  * the loader's per-process shards (`PrefetchLoader(process_index,
    process_count)`) equal the JAX loader's for the same seed and sizes, and
    partition the seeded permutation (the DistributedSampler contract, as
    tests/test_multihost.py holds the JAX loader to it);
  * `generate_face --view_parallel --device cpu` under `torchrun
    --standalone --nproc_per_node 2` (gloo) on tests/test_cli_integration.py's
    tiny inputs: rank 0 writes the strip and the NeuS2 data, within one
    uint8 level of the one-process strip with the same seed;
  * the train CLI for 2 steps under torchrun on 2 ranks on a synthetic
    FaceScape tree: one checkpoint, written by rank 0, step lines from rank
    0 only; it resumes in one process for a third step; and
    `--rss_restart_gb` is refused on more than one rank.

Every subprocess has a timeout, and the ranks run one torch thread each.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from morphablediffusion_torch.apps import generate_face as T
from morphablediffusion_torch.data.loader import PrefetchLoader as TLoader
from morphablediffusion_tpu.data.loader import PrefetchLoader as JLoader
from tests.test_cli_integration import _tiny_inputs
from tests.test_torch_train_cli import TRAIN_YAML, UIDS, _facescape_layout

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240


class _IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int32(i)}


def _epoch(loader, world):
    """One epoch of a loader's batches: the dataset indices in order."""
    it = loader.epochs()
    try:
        n = len(loader.dataset) // world // loader.batch_size
        return [int(i) for _ in range(n) for i in next(it)["idx"]]
    finally:
        it.close()


@pytest.mark.parametrize("world", [2, 3])
def test_loader_shards_match_jax_and_partition_the_permutation(world):
    ds = _IndexDataset(24)
    kw = dict(batch_size=4, shuffle=True, seed=11, num_workers=1, process_count=world)
    shards = []
    for rank in range(world):
        ours = _epoch(TLoader(ds, process_index=rank, **kw), world)
        assert ours == _epoch(JLoader(ds, process_index=rank, **kw), world)
        shards.append(ours)
    flat = [i for s in shards for i in s]
    assert len(flat) == 24 and len(set(flat)) == 24
    order = np.random.default_rng(11).permutation(24)
    for rank in range(world):
        assert shards[rank] == [int(i) for i in order[rank::world]]


def _torchrun(args, nproc=2, timeout=TIMEOUT):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", *args],
        capture_output=True, text=True, env=env, timeout=timeout)


def test_generate_face_view_parallel_under_torchrun(tmp_path):
    cfg, img, mesh = _tiny_inputs(tmp_path)
    common = ["--input_img", str(img), "--mesh", str(mesh), "--cfg", str(cfg), "--ckpt",
              "random", "--sample_steps", "2", "--device", "cpu"]
    one_views, _ = T.main(common + ["--output_dir", str(tmp_path / "one")])
    r = _torchrun(["morphablediffusion_torch.apps.generate_face", *common, "--output_dir",
                   str(tmp_path / "two"), "--view_parallel", "--prepare_neus2_data",
                   "--dist_backend", "gloo"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "rank 0 of 2: cpu (gloo)" in r.stdout and "rank 1 of 2: cpu (gloo)" in r.stdout
    assert r.stdout.count("wrote ") == 2  # the strip and the NeuS2 data, by rank 0 alone
    one = np.asarray(Image.open(tmp_path / "one" / "in_mesh.png")).astype(int)
    two = np.asarray(Image.open(tmp_path / "two" / "in_mesh.png")).astype(int)
    assert one.shape == two.shape == (64, 64 * 3, 3)
    assert np.abs(one - two).max() <= 1
    assert (tmp_path / "two" / "neus2_data" / "in_mesh" / "transform.json").is_file()
    assert len(one_views) == 2


def test_train_cli_under_torchrun_and_resumed_in_one_process(tmp_path):
    data, flame = _facescape_layout(tmp_path)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(TRAIN_YAML.replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {UIDS}\n  val_uids: ['002/02']\n").replace(
        "  batch_size: 2\n", "  batch_size: 1\n").replace(
        "  max_steps: 1\n", "  max_steps: 2\n").replace(
        "  val_check_interval: 1\n", "  val_check_interval: 2\n"))
    args = ["morphablediffusion_torch.apps.train", "-b", str(cfg), "-l", str(tmp_path / "runs"),
            "-n", "dp", "--device", "cpu"]
    r = _torchrun(args)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "rank 0 of 2: cpu (gloo)" in out and "rank 1 of 2: cpu (gloo)" in out
    for step in (1, 2):  # the step lines of rank 0 alone
        assert out.count(f"step {step} loss") == 1
    assert out.count("training done") == 1
    ckpt = tmp_path / "runs" / "dp" / "ckpt"
    assert (ckpt / "last" / "step").read_text() == "2"
    assert sorted(p.name for p in ckpt.rglob("*.pt")) == ["params.pt", "state.pt"]
    assert (tmp_path / "runs" / "dp" / "images" / "val" / "2.jpg").is_file()

    # the checkpoint of 2 ranks resumes in one process
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", *args[:-2], "--device", "cpu", "--resume",
                        "--max_steps", "3"],
                       capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 2" in r.stdout and "step 3 loss" in r.stdout

    r = _torchrun(args[:-2] + ["-n", "rss", "--device", "cpu", "--rss_restart_gb", "1"])
    assert r.returncode != 0 and "--rss_restart_gb runs on one rank only" in r.stderr
