"""The committed JAX-written Orbax fixture
(`morphablediffusion_torch/tools/fixtures/jax_orbax_tiny.*`) regenerated:
`tests/orbax_fixture.py` writes it again with the JAX package's
CheckpointManager, and every leaf of the new run directory equals the
committed list's sha256 (orbax's bytes are not deterministic, its leaves
are), read by the port's reader and, for the params export, by tensorstore
(the list was taken from tensorstore's read). And the fixture writer's
TrainState (`make_orbax_run.export_train_state`) against it: the port
resumes the JAX-written TrainState and writes it back leaf for leaf, with
the same metadata, zarr headers and shardings."""

import hashlib
import json

import numpy as np
import pytest
import torch

from morphablediffusion_torch.tools import make_orbax_run as W
from morphablediffusion_torch.training.trainer import Trainer
from morphablediffusion_torch.utils import orbax_reader as R
from morphablediffusion_torch.utils.checkpoint import CheckpointManager
from morphablediffusion_torch.weights import jax_shapes
from tests import orbax_fixture


def test_fixture_regenerates_leaf_for_leaf(tmp_path):
    """tests/orbax_fixture.py run again: every leaf of both step
    directories equals the committed list's sha256."""
    ckpt = orbax_fixture.write_run(tmp_path)
    want = json.loads(W.FIXTURE_LEAVES.read_text())
    for kind in ("params", "last"):
        tree = R.read_tree(ckpt / kind / str(W.FIXTURE_STEP))
        got = {}
        for path, a in tree.items():
            b = a.view(torch.uint16).numpy() if isinstance(a, torch.Tensor) else a
            got[".".join(map(str, path))] = hashlib.sha256(
                np.ascontiguousarray(b).tobytes()).hexdigest()
        assert got == want[kind], kind
    assert orbax_fixture.leaf_digests(ckpt / "params" / str(W.FIXTURE_STEP)) == want["params"]


def test_train_cli_resumes_the_fixture_then_its_own_checkpoint(tmp_path, capsys):
    """`train --resume` on a run directory that holds the fixture's JAX
    TrainState (its widened tiny config, accumulation 2, step 3) and no port
    checkpoint: it resumes at step 3, trains to max_steps and writes its own
    checkpoint beside JAX's step directories; resumed again, it takes its
    own."""
    from morphablediffusion_torch.apps import train
    from tests.test_torch_train_cli import TRAIN_YAML, UIDS, _facescape_layout

    data, flame = _facescape_layout(tmp_path)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(TRAIN_YAML.replace(
        "  dataset: facescape\n",
        f"  dataset: facescape\n  data_dir: {data}\n  flame_assets_dir: {flame}\n"
        f"  uids: {UIDS}\n  val_uids: ['002/02']\n").replace(
        "  val_check_interval: 1\n", "  val_check_interval: 0\n  accumulate_grad_batches: 2\n")
        .replace("model_channels: 32", "model_channels: 64")
        .replace("volume_dims: [8, 16, 32, 64]", "volume_dims: [16, 32, 64, 128]"))
    run = tmp_path / "runs" / "jax_run"
    W.unpack_fixture(run)
    argv = ["-b", str(cfg), "-l", str(tmp_path / "runs"), "-n", "jax_run", "--device", "cpu",
            "--resume"]
    train.main(argv + ["--max_steps", "5"])
    out = capsys.readouterr().out
    assert "resumed the JAX TrainState" in out and "resumed from step 3" in out
    assert "step 4 loss" in out and "step 5 loss" in out and "step 3 loss" not in out
    ckpt = run / "ckpt"
    assert (ckpt / "last" / "step").read_text() == "5"
    assert R.latest_step(ckpt / "last") == W.FIXTURE_STEP  # JAX's step directory stays
    train.main(argv + ["--max_steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "JAX TrainState" not in out and "step 6 loss" in out


def _bits(a):
    return a.view(torch.uint16).numpy() if isinstance(a, torch.Tensor) else a


def _step_files(step_dir):
    """(_METADATA, _sharding, every .zarray) of a step directory."""
    d = step_dir / "default"
    db = R.StepTree(step_dir).db
    return (json.loads((d / "_METADATA").read_text()), json.loads((d / "_sharding").read_text()),
            {k: v.read() for k, v in db.keys.items() if k.endswith(b"/.zarray")})


def test_train_state_writer_writes_the_jax_fixture_back(tmp_path):
    """The fixture's JAX TrainState resumed into a port Trainer and written
    again by `export_train_state`: every leaf bitwise the JAX-written one
    (dtype and shape too), and `_METADATA`, `_sharding` and each `.zarray`
    equal; except the accumulator of the parameters that take no gradient
    in the port (the VAE's and CLIP's), which the port does not hold and
    writes as zeros."""
    ckpt = W.unpack_fixture(tmp_path / "jax")
    tr = Trainer(W.fixture_config(), device="cpu")
    assert CheckpointManager(ckpt).restore(tr) == W.FIXTURE_STEP
    out = tmp_path / "port" / "ckpt"
    W.export_train_state(tr, out)
    step = str(W.FIXTURE_STEP)
    jax_dir, port_dir = ckpt / "last" / step, out / "last" / step
    assert _step_files(port_dir) == _step_files(jax_dir)
    a, b = R.read_tree(jax_dir), R.read_tree(port_dir)
    assert a.keys() == b.keys()
    grads = {n for n, _ in tr.grad_params()}
    names = [n for n, _ in tr.model.named_parameters()]
    held = {("opt_state", "acc_grads", "params") + tuple(path.split("/"))
            for n, path in zip(names, jax_shapes(tr.model)) if n in grads}
    for path, x in a.items():
        y = b[path]
        assert type(x) is type(y) and x.dtype == y.dtype and x.shape == y.shape, path
        if path[:2] == ("opt_state", "acc_grads") and path not in held:
            assert not _bits(y).any(), path
        else:
            assert np.array_equal(_bits(x), _bits(y)), path


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_state_round_trip(tmp_path, accumulate):
    """A port Trainer's state (seeded moments and accumulator at micro-step
    3), written by `export_train_state` and restored into a new Trainer:
    the same parameters, AdamW moments and steps, accumulator and
    counters."""
    from morphablediffusion_torch.tools.common import tiny_config

    cfg = tiny_config()
    cfg.train.accumulate_grad_batches = accumulate
    a = Trainer(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    a.step, a.opt_step = 3, 3 // accumulate
    for group in a.optimizer.param_groups:
        for p in group["params"]:
            a.optimizer.state[p] = {"step": torch.tensor(float(a.opt_step)),
                                    "exp_avg": torch.randn(p.shape, generator=g),
                                    "exp_avg_sq": torch.rand(p.shape, generator=g)}
    if accumulate > 1:
        a._acc = {n: torch.randn(p.shape, generator=g).to(p.dtype) for n, p in a.grad_params()}
    W.export_train_state(a, tmp_path / "ckpt")
    b = Trainer(cfg, device="cpu", seed=1)
    assert CheckpointManager(tmp_path / "ckpt").restore(b) == 3
    assert (b.step, b.opt_step) == (3, 3 // accumulate)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa["model"][k], sb["model"][k]) for k in sa["model"])
    assert sa["optimizer"]["state"].keys() == sb["optimizer"]["state"].keys()
    for i, st in sa["optimizer"]["state"].items():
        assert all(torch.equal(st[k], sb["optimizer"]["state"][i][k]) for k in st), i
    assert (sb["acc"] is None) == (accumulate == 1)
    if accumulate > 1:
        assert sa["acc"].keys() == sb["acc"].keys()
        assert all(torch.equal(sa["acc"][n], sb["acc"][n]) for n in sa["acc"])
