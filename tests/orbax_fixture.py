"""The JAX-written Orbax run directory the port's tests and `chip_smoke.py`
read: how it is made (not a test module).

    JAX_PLATFORMS=cpu python -m tests.orbax_fixture

rewrites `morphablediffusion_torch/tools/fixtures/jax_orbax_tiny.tar.gz`: a
run directory of the JAX package's own `utils/checkpoint.py::CheckpointManager`
at `tests/tiny.py`'s config widened as `torch_parity.train_config` widens it
(UNet width 64, volume dims 16 - 128) with `accumulate_grad_batches` 2,
holding

    ckpt/params/3/   the params export ({'params': ...}, VAE and CLIP in bf16)
    ckpt/last/3/     the TrainState after 3 micro-steps of the JAX package's
                     optimizer (`make_optimizer`: optax.MultiSteps over the
                     base/cond AdamWs): step 3, mini_step 1, gradient_step 1,
                     AdamW count 1, moments and a half-full accumulator

and `jax_orbax_tiny.leaves.json` beside it, the sha256 of every leaf's
bytes as tensorstore reads them. The parameters and the three gradients are periodic (a seeded
pattern of PERIOD values laid along each leaf's C order, a prime period so
that no two output channels repeat), so that the parameters and their
optimizer state compress to a few hundred KiB; the optimizer steps
are the JAX package's own arithmetic on them. No model gradient is taken:
the fixture is about the format and the optimizer state's layout.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tarfile
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

REPO = Path(__file__).resolve().parents[1]
STEP = 3
PERIOD = 31


def fixture_config():
    """tests/tiny.py's config (two views) widened as the training parity
    tests widen it (`torch_parity.train_config`: every GroupNorm group
    holds two channels or more, so no bias gradient is rounding alone), with
    gradient accumulation 2: `make_orbax_run.fixture_config` in the port."""
    sys.path.insert(0, str(REPO))
    from tests.torch_parity import train_config

    cfg = train_config()
    cfg.train.accumulate_grad_batches = 2
    return cfg


def periodic_tree(tree, seed: int, grads: bool = False):
    """Same structure as `tree`: each leaf a seeded pattern of PERIOD values
    repeated along its C order. Parameters: norm scales 1 + 0.1 p, biases
    0.1 p, kernels p / sqrt(fan_in), other leaves 0.02 p; gradients 1e-2 p."""
    pattern = np.random.default_rng(seed).standard_normal(PERIOD).astype(np.float32)

    def leaf(path, s):
        shape = tuple(s.shape)
        p = pattern[np.arange(int(np.prod(shape))) % PERIOD].reshape(shape)
        name = str(path[-1].key)
        if grads:
            v = 1e-2 * p
        elif name == "scale":
            v = 1.0 + 0.1 * p
        elif name == "bias":
            v = 0.1 * p
        elif len(shape) >= 2:
            v = p / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.02 * p
        return jnp.asarray(v.astype(np.float32)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def train_state(cfg):
    """The TrainState of the fixture (see the module docstring)."""
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion
    from morphablediffusion_tpu.parallel.mesh import create_mesh
    from morphablediffusion_tpu.training.trainer import TrainState, Trainer, make_optimizer
    from tests.tiny import tiny_batch

    model = MorphableDiffusion(cfg.model)
    names = ["params", "time", "noise", "view", "vae", "drop"]
    rngs = dict(zip(names, jax.random.split(jax.random.key(0), len(names))))
    abstract = jax.eval_shape(lambda b: model.init(rngs, b, method="init_fn"),
                              tiny_batch(cfg))
    params = Trainer(cfg, mesh=create_mesh(jax.devices()[:1])).cast_frozen(
        periodic_tree(abstract, seed=0))
    tx, _ = make_optimizer(cfg, params)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    for k in range(STEP):
        updates, opt_state = update(periodic_tree(params, seed=1 + k, grads=True),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)
    return TrainState(step=jnp.asarray(STEP, jnp.int32), params=params,
                      opt_state=opt_state, rng=jax.random.key(cfg.train.seed))


def write_run(out: Path) -> Path:
    """Write the fixture's run directory under `out`; returns its ckpt
    directory."""
    from morphablediffusion_tpu.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(out / "ckpt")
    mgr.maybe_save(train_state(fixture_config()), STEP, force=True)
    mgr.wait()
    return out / "ckpt"


def digests(ckpt: Path) -> dict:
    """{'params' | 'last': leaf_digests of its step STEP}."""
    return {kind: leaf_digests(ckpt / kind / str(STEP)) for kind in ("params", "last")}


def write(archive: Path, leaves: Path) -> None:
    """The committed fixture: the run directory as a tar.gz (its JSON
    metadata is most of its 7 MB; gzip takes it under 1 MB) and the leaves'
    sha256 as JSON."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_run(Path(tmp))
        with tarfile.open(archive, "w:gz") as tar:
            tar.add(ckpt, arcname="ckpt")
        leaves.write_text(json.dumps(digests(ckpt), indent=0, sort_keys=True) + "\n")


def leaf_digests(step_dir: Path) -> dict:
    """{dot-joined leaf path: sha256 of its bytes} of a StandardSave step
    directory, read by tensorstore (bf16 leaves as their uint16 bits)."""
    import tensorstore as ts

    d = step_dir / "default"
    meta = json.loads((d / "_METADATA").read_text())
    out = {}
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):  # no data
            continue
        name = ".".join(str(k["key"]) for k in entry["key_metadata"])
        spec = {"driver": "zarr", "path": name,
                "kvstore": {"driver": "ocdbt", "base": f"file://{d}/"}}
        a = np.asarray(ts.open(spec).result().read().result())
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        out[name] = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    from morphablediffusion_torch.tools.make_orbax_run import FIXTURE, FIXTURE_LEAVES

    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    write(FIXTURE, FIXTURE_LEAVES)
    print(f"wrote {FIXTURE} and {FIXTURE_LEAVES}")
