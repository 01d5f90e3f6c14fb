"""The port's reader of the JAX package's Orbax checkpoints
(`morphablediffusion_torch/utils/orbax_reader.py`), its fixture writer
(`tools/make_orbax_run.py`) and the entry points that take a JAX run
directory, against orbax, tensorstore and the JAX package on the CPU.

Every comparison is bitwise (bf16 leaves as their uint16 bits) except the
slice's output, which is held at tests/test_torch_sampler.py's 1e-4. The
directories are written by the JAX package's own
`utils/checkpoint.py::CheckpointManager` (orbax 0.11): leaves of fp32, bf16,
int32 and a uint32 threefry key, 0-, 1- and 4-D, an array sharded over the
test mesh's CPU devices (one zarr chunk a shard), a list (sequence keys);
and, with orbax's OCDBT node size cut to 1 KiB and its data files to 4 KiB
(orbax's own 100 MB nodes keep a 3 000-leaf tree in one leaf node; at 1 KiB
the b-tree reaches height 2 at 20 - 30 leaves), a tree of height >= 2 whose
values span several data files. The resumed training steps are in
test_torch_orbax_resume.py."""

import hashlib
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from flax import struct
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from orbax.checkpoint._src.serialization import tensorstore_utils

from morphablediffusion_torch.apps import eval_2d as T2d
from morphablediffusion_torch.apps import generate_face as Tgf
from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.tools import int8_trajectory as Tint8
from morphablediffusion_torch.tools import make_orbax_run as W
from morphablediffusion_torch.training.trainer import cast_frozen
from morphablediffusion_torch.utils import orbax_reader as R
from morphablediffusion_torch.utils.checkpoint import CheckpointManager as TManager
from morphablediffusion_torch.weights import (cast_for_serving, flatten_tree, from_jax_params,
                                              seeded_params, to_jax_layout)
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.parallel.mesh import create_mesh
from morphablediffusion_tpu.training.trainer import Trainer as JTrainer
from morphablediffusion_tpu.utils.checkpoint import CheckpointManager as JManager
from tests import orbax_fixture, torch_parity
from tests.test_cli_integration import _tiny_inputs
from tests.tiny import tiny_batch, tiny_config


@struct.dataclass
class State:
    """A TrainState-shaped pytree: what the JAX manager's maybe_save takes
    (`last/` holds it all, `params/` its params)."""
    step: jnp.ndarray
    params: dict
    opt_state: dict
    rng: jnp.ndarray


def jax_save(ckpt, params, opt_state=None, step: int = 1) -> State:
    state = State(step=jnp.asarray(step, jnp.int32), params=params, opt_state=opt_state or {},
                  rng=jax.random.key(3))
    mgr = JManager(ckpt)
    mgr.maybe_save(state, step, force=True)
    mgr.wait()
    return state


def bits(a) -> np.ndarray:
    """A leaf's bytes as numpy (bf16 as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint16).numpy()
    if jnp.issubdtype(getattr(a, "dtype", None), jax.dtypes.prng_key):
        a = jax.random.key_data(a)  # a threefry key: its uint32[2]
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


def ts_read(step_dir, path) -> np.ndarray:
    d = R.step_dir_of(step_dir)
    spec = {"driver": "zarr", "path": ".".join(map(str, path)),
            "kvstore": {"driver": "ocdbt", "base": f"file://{d}/"}}
    return bits(ts.open(spec).result().read().result())


def assert_tree_equal(got: dict, want_leaves, step_dir, use_tensorstore: bool = True):
    """The reader's tree against the JAX tree's leaves (path -> array) and
    tensorstore's read of each, dtype, shape and bits."""
    assert set(got) == set(want_leaves), (sorted(set(got) ^ set(want_leaves))[:5])
    for path, a in got.items():
        refs = [bits(want_leaves[path])]
        if use_tensorstore:
            refs.append(ts_read(step_dir, path))
        for ref in refs:
            b = bits(a)
            assert b.dtype == ref.dtype and b.shape == ref.shape, path
            assert np.array_equal(b, ref), path


def leaves(tree) -> dict:
    """{path tuple (str keys, int indices): leaf} of a JAX pytree."""
    out = {}
    for kp, leaf in jax.tree_util.tree_leaves_with_path(tree):
        path = []
        for k in kp:
            if isinstance(k, jax.tree_util.SequenceKey):
                path.append(k.idx)
            elif isinstance(k, jax.tree_util.GetAttrKey):
                path.append(k.name)
            else:
                path.append(k.key)
        out[tuple(path)] = leaf
    return out


def kinds_tree():
    """Leaves of every kind the JAX runs hold, names with '_' and digits."""
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    return {"params": {
        "Conv_0": {"kernel": jnp.asarray(rng.standard_normal((3, 3, 4, 8)), jnp.float32),
                   "bias": jnp.asarray(rng.standard_normal(8), jnp.float32)},
        "first_stage": {"w_1": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
                        "b": jnp.asarray(rng.standard_normal(3), jnp.bfloat16)},
        "count_2": jnp.asarray(7, jnp.int32),
        "layers": [jnp.asarray(rng.standard_normal(4), jnp.float32),
                   jnp.asarray(rng.standard_normal((2, 2)), jnp.float32)],
        "sharded": jax.device_put(jnp.asarray(rng.standard_normal((8, 6)), jnp.float32),
                                  NamedSharding(mesh, P("a", "b"))),
        "big": jnp.asarray(rng.standard_normal((64, 128)), jnp.float32),
    }}


def test_reader_matches_tensorstore_and_orbax(tmp_path):
    """params/ and last/ of a JAX run: every leaf of the reader's tree equal
    to tensorstore's read and to the JAX manager's restore; the sharded
    array assembled from its chunks, the key a uint32[2], the scalars 0-d."""
    ckpt = tmp_path / "ckpt"
    params = kinds_tree()
    state = jax_save(ckpt, params, opt_state={"mu": params}, step=5)
    restored = JManager(ckpt).restore(state)
    p_restored = JManager(ckpt).restore_params(params)
    assert R.latest_step(ckpt / "last") == R.latest_step(ckpt / "params") == 5
    last = R.read_tree(ckpt / "last" / "5")
    assert_tree_equal(last, leaves(restored), ckpt / "last" / "5")
    assert_tree_equal(R.read_tree(ckpt / "params" / "5"), leaves(p_restored),
                      ckpt / "params" / "5")
    assert last[("rng",)].dtype == np.uint32 and last[("rng",)].shape == (2,)
    assert np.array_equal(last[("rng",)], np.asarray(jax.random.key_data(jax.random.key(3))))
    assert last[("step",)].shape == () and int(last[("step",)]) == 5
    assert last[("params", "params", "first_stage", "w_1")].dtype == torch.bfloat16
    db = R.OcdbtDatabase(R.step_dir_of(ckpt / "last" / "5"))
    chunks = [k for k in db.keys if k.startswith(b"params.params.sharded/") and b".z" not in k]
    assert len(chunks) == 4  # one chunk a shard
    assert R.flat_params(R.read_tree(ckpt / "params" / "5")).keys() == {
        "Conv_0/kernel", "Conv_0/bias", "first_stage/w_1", "first_stage/b", "count_2",
        "layers/0", "layers/1", "sharded", "big"}


def test_reader_reads_a_deep_tree_over_many_data_files(tmp_path, monkeypatch):
    """orbax's OCDBT writes with 1 KiB nodes and 4 KiB data files: a b-tree
    of height >= 2 (interior nodes, keys stored without their subtree's
    common prefix) whose values lie in several data files."""
    add = tensorstore_utils.add_ocdbt_write_options

    def small(spec, target_data_file_size=None):
        add(spec, target_data_file_size=4096)
        spec["config"]["max_decoded_node_bytes"] = 1024

    monkeypatch.setattr(tensorstore_utils, "add_ocdbt_write_options", small)
    rng = np.random.default_rng(1)
    params = {"params": {f"layer_{i}": {"kernel": jnp.asarray(rng.standard_normal((4, 75)),
                                                             jnp.float32)}
                         for i in range(40)}}
    ckpt = tmp_path / "ckpt"
    jax_save(ckpt, params)
    step_dir = ckpt / "params" / "1"
    db = R.OcdbtDatabase(R.step_dir_of(step_dir))
    assert db.height >= 2
    assert len({v.path for v in db.keys.values() if v.path is not None}) > 1
    assert_tree_equal(R.read_tree(step_dir), leaves(JManager(ckpt).restore_params(params)),
                      step_dir)


def test_reader_raises_on_bad_crc_missing_keys_and_without_libzstd(tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    jax_save(ckpt, {"params": {"w": jnp.ones((4, 4))}})
    step_dir = R.step_dir_of(ckpt / "params" / "1")
    db = R.OcdbtDatabase(step_dir)
    with pytest.raises(KeyError, match="no array"):
        R.read_array(db, "params.missing")
    node_file = next(p for p in (step_dir / "d").iterdir())
    for path in (step_dir / "manifest.ocdbt", node_file):
        bad = tmp_path / "bad"
        shutil.rmtree(bad, ignore_errors=True)
        shutil.copytree(step_dir, bad)
        target = bad / path.relative_to(step_dir)
        raw = bytearray(target.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        target.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="CRC-32C mismatch"):
            R.read_tree(bad)

    def no_lib(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(R, "_ZSTD", None)
    monkeypatch.setattr(R.ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libzstd"):
        R.read_tree(ckpt / "params" / "1")


def test_slice_from_a_jax_orbax_export_matches_jax(tmp_path, monkeypatch):
    """JAX parameters -> the JAX manager's params export -> the port's
    CheckpointManager.restore_params: the slice (tests/test_torch_sampler.py's
    sampler run) against the JAX package's at its 1e-4."""
    seen = []

    def through_orbax(module, params):
        ckpt = tmp_path / "ckpt"
        jax_save(ckpt, jax.tree.map(jnp.asarray, params))
        seen.append(len(jax.tree.leaves(params)))
        return TManager(ckpt).restore_params(module).eval()

    monkeypatch.setattr(torch_parity, "load_into", through_orbax)
    r = torch_parity.sampler_run(tiny_config(view_num=2))
    assert seen and seen[0] == len(list(TModel(torch_parity.port_model_config(
        tiny_config(view_num=2).model), device="cpu").parameters()))
    torch_parity.assert_slice_matches(r, 1e-4)


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """The committed JAX-written fixture unpacked, its params export as the
    JAX package restores it (JAX's generate_face path: an abstract tree,
    shardings from the directory; also the writer test's template), and
    tiny YAML inputs at the fixture's widths."""
    tmp = tmp_path_factory.mktemp("fixture")
    ckpt = W.unpack_fixture(tmp)
    jcfg = orbax_fixture.fixture_config()
    jmodel = JModel(jcfg.model)
    names = ["params", "time", "noise", "view", "vae", "drop"]
    rngs = dict(zip(names, jax.random.split(jax.random.key(0), len(names))))
    abstract = jax.eval_shape(lambda b: jmodel.init(rngs, b, method="init_fn"),
                              tiny_batch(jcfg))
    abstract = jax.eval_shape(JTrainer(jcfg, mesh=create_mesh(jax.devices()[:1])).cast_frozen,
                              abstract)
    jparams = JManager(ckpt).restore_params(abstract)
    cfg, img, mesh = _tiny_inputs(tmp)
    cfg.write_text(cfg.read_text().replace("model_channels: 32", "model_channels: 64").replace(
        "volume_dims: [8, 16, 32, 64]", "volume_dims: [16, 32, 64, 128]"))
    return dict(ckpt=ckpt, jparams=jparams, abstract=abstract, inputs=(cfg, img, mesh),
                tmp=tmp)


def test_committed_fixture_reads_to_its_leaf_list(fixture_run):
    """The CPU side of chip_smoke.py phase 15 (d): both step directories of
    the committed fixture, every leaf's sha256 the committed list's, and the
    params export equal to the JAX package's restore of it."""
    want = json.loads(W.FIXTURE_LEAVES.read_text())
    for kind in ("params", "last"):
        tree = R.read_tree(fixture_run["ckpt"] / kind / str(W.FIXTURE_STEP))
        got = {".".join(map(str, p)): hashlib.sha256(np.ascontiguousarray(bits(a)).tobytes())
               .hexdigest() for p, a in tree.items()}
        assert got == want[kind]
    tree = R.read_tree(fixture_run["ckpt"] / "params" / str(W.FIXTURE_STEP))
    assert_tree_equal(tree, leaves(fixture_run["jparams"]), None, use_tensorstore=False)
    assert W.FIXTURE.stat().st_size + W.FIXTURE_LEAVES.stat().st_size <= 2 * 2**20


def port_export(tmp, jparams):
    """The same JAX tree through `from_jax_params`, as the port's own params
    export (its train CLI's layout)."""
    d = tmp / "port_ckpt"
    (d / "params").mkdir(parents=True, exist_ok=True)
    torch.save(from_jax_params(flatten_tree(jparams["params"]), device="cpu"),
               d / "params" / "params.pt")
    return d


def test_generate_face_cli_on_a_jax_run_directory(fixture_run):
    """generate_face --device cpu with --ckpt the JAX run directory (and
    with its params/<step> directory) equals the port on the same tree
    loaded through from_jax_params, bitwise."""
    cfg, img, mesh = fixture_run["inputs"]
    tmp = fixture_run["tmp"]
    views = {}
    for label, ckpt in (("jax", fixture_run["ckpt"]),
                        ("step", fixture_run["ckpt"] / "params" / str(W.FIXTURE_STEP)),
                        ("port", port_export(tmp, fixture_run["jparams"]))):
        views[label], report = Tgf.main([
            "--input_img", str(img), "--mesh", str(mesh), "--cfg", str(cfg), "--ckpt", str(ckpt),
            "--output_dir", str(tmp / f"out_{label}"), "--sample_steps", "2", "--device",
            "cpu"])
        assert report["import"] is None
    assert np.isfinite(views["jax"]).all() and views["jax"].std() > 0
    np.testing.assert_array_equal(views["jax"], views["port"])
    np.testing.assert_array_equal(views["step"], views["port"])


def test_eval_2d_takes_the_clip_tower_of_a_jax_run(fixture_run, monkeypatch):
    """eval_2d's CLIP tower from a JAX run directory: the tower's leaves
    alone are read, and the tower equals from_jax_params of the JAX
    package's restore."""
    read = []
    real = R.read_array
    monkeypatch.setattr(R, "read_array", lambda db, name: read.append(name) or real(db, name))
    cfg = fixture_run["inputs"][0]
    enc = T2d._load_clip_encoder(str(fixture_run["ckpt"]), str(cfg), "cpu")
    assert read and all(n.startswith("params.clip_image_encoder.") for n in read)
    want = from_jax_params(flatten_tree(fixture_run["jparams"]["params"]["clip_image_encoder"]),
                           device="cpu")
    got = enc.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_int8_trajectory_takes_a_jax_run_and_the_native_cache(fixture_run):
    """int8_trajectory's --ckpt: the JAX run directory, and an Orbax params
    tree written as the JAX tool's --native_cache (PyTreeCheckpointer), each
    the serving model of the tree through from_jax_params."""
    cfg = W.fixture_config()
    native = fixture_run["tmp"] / "native_cache"
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(native, args=ocp.args.PyTreeSave(fixture_run["jparams"]))
    want = TModel(cfg.model, device="cpu")
    want.load_state_dict(from_jax_params(flatten_tree(fixture_run["jparams"]["params"]),
                                         device="cpu"))
    want = cast_for_serving(want).state_dict()
    for ckpt in (fixture_run["ckpt"], native):
        got = Tint8.load_model(cfg, str(ckpt), "cpu").state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], v) for k, v in want.items()), ckpt


def test_writer_output_restores_in_jax_bit_for_bit(tmp_path, fixture_run):
    """make_orbax_run's params export of a seeded tiny port model (VAE and
    CLIP in bf16): the JAX manager's restore_params, tensorstore and the
    reader give every parameter back bit for bit, and the port's
    restore_params the model itself."""
    cfg = W.fixture_config()
    model = seeded_params(TModel(cfg.model, device="cpu"), 0)
    cast_frozen(model)
    ckpt = tmp_path / "ckpt"
    W.export_params(model, ckpt, step=4)
    step_dir = ckpt / "params" / "4"
    # JAX's generate_face path: the tiny model's abstract tree (VAE and CLIP
    # bf16), shardings from the directory
    restored = leaves(JManager(ckpt).restore_params(fixture_run["abstract"]))
    named = dict(model.named_parameters())
    want = {("params",) + tuple(p.split("/")): a
            for p, a in to_jax_layout(model, named).items()}
    half = {("params",) + tuple(p.split("/")) for p, n in zip(to_jax_layout(model, named), named)
            if named[n].dtype == torch.bfloat16}
    assert set(restored) == set(want) and half
    for path, a in restored.items():
        assert (a.dtype == jnp.bfloat16) == (path in half), path
        assert np.array_equal(np.asarray(a.astype(jnp.float32)), want[path]), path
    assert_tree_equal(R.read_tree(step_dir), restored, step_dir)
    back = TManager(ckpt).restore_params(TModel(cfg.model, device="cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k].to(v.dtype), v), k


def test_an_export_from_another_device_restores_in_the_port_not_in_jax(tmp_path):
    """A params export whose `_sharding` names a device this host lacks (a
    run written on a TPU: 'TPU_0'): the JAX CLIs restore with an abstract
    tree that carries no sharding (`apps/generate_face.py::load_params`), so
    orbax takes each leaf's device from that file and raises; the port
    reads the leaves, which hold no device."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    step_dir = tmp_path / "ckpt" / "params" / "1"
    W.write_step(step_dir, {("params", "w"): w})
    sharding = step_dir / "default" / "_sharding"
    sharding.write_text(sharding.read_text().replace(W.DEVICE, "TPU_0"))
    abstract = jax.eval_shape(lambda: {"params": {"w": jnp.zeros((2, 3))}})
    with pytest.raises(ValueError, match="sharding"):
        JManager(tmp_path / "ckpt").restore_params(abstract)
    assert np.array_equal(R.read_tree(tmp_path / "ckpt" / "params" / "1")[("params", "w")], w)
