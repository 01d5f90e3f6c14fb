"""The port's reader of flax-msgpack weight files (`utils/flax_msgpack.py`)
against flax's own `msgpack_restore`, and the two loaders it feeds:

  * the reader gives flax's tree bit for bit (the same keys, types, shapes,
    dtypes and bytes; a bf16 leaf as a torch.bfloat16 tensor holding the
    same bits) on the shipped `artifacts/landmark_net_synth.msgpack` and
    on flax-written files with bf16, fp16, int and bool leaves, numpy
    scalars, a complex, nested meta and a chunked leaf; it raises on every
    truncation, on trailing bytes and on an ext code flax does not write;
  * `keypoint_net.load_params` takes the shipped net, told from a `.pt` by
    content, and its keypoints on seeded 128^2 images lie within 1e-3 px of
    the JAX package's `detect`;
  * `train_vae.load_vae` takes the JAX CLI's `save_vae` file and the train
    CLI's graft (`train.graft_vae`) equals the JAX graft leaf for leaf; the
    meta keys carry across unchanged (both CLIs fold the latent scale into
    the parameters before writing, so nothing is folded again)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from morphablediffusion_torch.utils import flax_msgpack as fm

SHIPPED = str(Path(__file__).resolve().parents[1] / "artifacts" / "landmark_net_synth.msgpack")


def assert_same_tree(ours, theirs, path="") -> None:
    """Bitwise equality of a reader tree and a flax tree."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), path
        for k in theirs:
            assert_same_tree(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(theirs, (np.ndarray, np.generic)) and theirs.dtype == jnp.bfloat16:
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == np.shape(theirs), path
        assert ours.view(torch.int16).numpy().tobytes() == np.asarray(theirs).tobytes(), path
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert (ours.dtype, ours.shape) == (theirs.dtype, theirs.shape), path
        assert ours.tobytes() == theirs.tobytes(), path
    elif isinstance(theirs, np.generic):
        assert type(ours) is type(theirs) and ours.tobytes() == theirs.tobytes(), path
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


def _mixed_tree(rng):
    return {
        "params": {
            "bf16": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
            "fp16": rng.normal(size=(4,)).astype(np.float16),
            "fp32": rng.normal(size=(2, 3, 2)).astype(np.float32),
            "fp64": rng.normal(size=(3,)),
            "int8": rng.integers(-128, 127, (6,)).astype(np.int8),
            "int64": rng.integers(-2**40, 2**40, (2, 2)),
            "uint16": rng.integers(0, 2**16, (5,)).astype(np.uint16),
            "bool": rng.uniform(size=(7,)) > 0.5,
            "empty": np.zeros((0, 3), np.float32),
            "scalar0d": np.asarray(3.5, np.float32),
        },
        "meta": {
            "ch": 32, "ch_mult": [1, 2, 2, 4], "neg": -7, "big": 2**40, "small": -2**33,
            "latent_std_raw": 0.8731, "name": "vae", "nothing": None, "flag": True,
            "raw": b"\x00\x01\xff", "nested": {"deep": {"x": [1.5, "s", [2, 3]]}},
            "complex": 1.5 - 2.25j,
            "np_f32": np.float32(0.25), "np_i64": np.int64(-3), "np_bool": np.bool_(True),
            "np_bf16": jnp.bfloat16(1.5),
            "long_str": "x" * 300, "long_list": list(range(20)),
            "many": {f"k{i}": i for i in range(20)},
        },
    }


def test_shipped_landmark_net_bitwise():
    data = open(SHIPPED, "rb").read()
    ours, theirs = fm.loads(data), serialization.msgpack_restore(data)
    assert_same_tree(ours, theirs)
    flat = fm.flatten(ours["params"]["params"])
    assert ours["num_keypoints"] == 68 and len(flat) == 66
    assert sum(v.size for v in flat.values()) == 3_422_980
    assert all(v.dtype == np.float32 for v in flat.values())


@pytest.mark.parametrize("chunk", [None, 16])
def test_flax_written_trees_bitwise(tmp_path, monkeypatch, chunk):
    """A flax-written file of every leaf kind; with chunk, leaves over
    `chunk` bytes are written as chunked dicts (flax's MAX_CHUNK_SIZE
    lowered for the test), joined back by both readers."""
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    tree = _mixed_tree(np.random.default_rng(0))
    data = serialization.msgpack_serialize(tree)
    if chunk is not None:
        raw = msgpack.unpackb(data, raw=False, ext_hook=lambda c, d: None)
        assert fm.CHUNKED in raw["params"]["fp32"] and fm.CHUNKED in raw["params"]["bf16"]
    path = tmp_path / "tree.msgpack"
    path.write_bytes(data)
    ours, theirs = fm.restore(path), serialization.msgpack_restore(data)
    assert_same_tree(ours, theirs)
    assert isinstance(ours["meta"]["complex"], complex)
    flat = fm.flatten(ours["params"])
    assert flat["bf16"].dtype == np.float32
    np.testing.assert_array_equal(flat["bf16"], np.asarray(tree["params"]["bf16"], np.float32))


def test_top_level_array_and_to_bytes():
    """flax.serialization.to_bytes (the landmark net's writer) and a bare
    array at the top."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert_same_tree(fm.loads(serialization.msgpack_serialize(a)),
                     serialization.msgpack_restore(serialization.msgpack_serialize(a)))
    blob = serialization.to_bytes({"num_keypoints": 68, "params": {"w": a}})
    assert_same_tree(fm.loads(blob), serialization.msgpack_restore(blob))


def test_raises_on_truncation_trailing_bytes_and_unknown_ext():
    data = serialization.msgpack_serialize(_mixed_tree(np.random.default_rng(1)))
    for n in list(range(0, 64)) + list(range(64, len(data), 97)) + [len(data) - 1]:
        with pytest.raises(ValueError):
            fm.loads(data[:n])
    with pytest.raises(ValueError, match="trailing"):
        fm.loads(data + b"\xc0")
    bad = [msgpack.packb({"a": msgpack.ExtType(code, b"\x01\x02")}) for code in (0, 4, 42)]
    bad.append(b"\x81\xa1a\xd5\xff\x01\x02")  # fixext 2 of type -1 (msgpack's timestamp)
    for data in bad:
        with pytest.raises(ValueError, match="ext type"):
            fm.loads(data)
    with pytest.raises(ValueError):
        fm.loads(b"\xc1")  # never used by msgpack
    with pytest.raises(ValueError):
        fm.loads(msgpack.packb({1: 2}))  # flax writes string keys only


def test_shipped_net_keypoints_match_jax(tmp_path):
    from morphablediffusion_torch.eval import keypoint_net as T
    from morphablediffusion_tpu.eval import keypoint_net as J

    net = T.load_params(SHIPPED, "cpu")
    assert net.num_keypoints == 68
    jnet, jparams = J.load_params(SHIPPED, 128)
    X = np.random.default_rng(0).uniform(0, 1, (6, 128, 128, 3)).astype(np.float32)
    ours, theirs = T.detect(net, X), J.detect(jnet, jparams, X)
    assert ours.shape == (6, 68, 2)
    assert float(np.abs(ours - theirs).max()) < 1e-3
    # told apart by content, not by suffix: a .pt named .msgpack, and the
    # msgpack named .pt, load the same net
    pt = tmp_path / "net.msgpack"
    T.save_params(pt, net)
    renamed = tmp_path / "shipped.pt"
    renamed.write_bytes(open(SHIPPED, "rb").read())
    for p in (pt, renamed):
        np.testing.assert_array_equal(T.detect(T.load_params(p, "cpu"), X), ours)
    with pytest.raises(ValueError):
        T.load_params(_write(tmp_path / "junk.pt", b"\x93\x01"), "cpu")


def _write(path, data):
    path.write_bytes(data)
    return path


META = dict(ch=32, ch_mult=[1, 1, 1, 1], num_res_blocks=1, image_size=64,
            latent_std_raw=0.61, fold_scale=8.99)


def test_jax_train_vae_file_grafts_as_jax(tmp_path):
    """JAX `save_vae` of seeded parameters of tests/tiny.py's VAE, grafted
    by the port's train CLI into its first stage, equals the JAX CLI's
    graft (the file's leaves cast to each first-stage leaf's dtype) leaf for
    leaf; a file of another architecture is refused."""
    from morphablediffusion_torch.apps import train as t_train
    from morphablediffusion_torch.apps import train_vae as t_vae
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
    from morphablediffusion_torch.weights import flatten_tree, to_jax_layout
    from morphablediffusion_tpu.apps import train_vae as j_vae
    from morphablediffusion_tpu.models.vae import AutoencoderKL
    from tests.tiny import tiny_config
    from tests.torch_parity import port_model_config, seeded_tree

    cfg = tiny_config(view_num=2)
    jvae = AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
    params = seeded_tree(jax.eval_shape(lambda x: jvae.init(jax.random.key(0), x),
                                        jnp.zeros((1, 64, 64, 3))), seed=3)
    path = tmp_path / "vae.msgpack"
    j_vae.save_vae(str(path), params, META)
    j_params, j_meta = j_vae.load_vae(str(path))

    state, meta = t_vae.load_vae(str(path))
    assert meta == j_meta == META  # every meta key carries across as written
    want = flatten_tree(j_params["params"])
    port = TModel(port_model_config(cfg.model), device="cpu")
    port.first_stage.to(torch.bfloat16)  # frozen leaves stored in bf16, as cast_frozen
    t_train.graft_vae(port, str(path))
    got = to_jax_layout(port.first_stage, dict(port.first_stage.named_parameters()))
    assert got.keys() == want.keys() and len(state) == len(want)
    for k, v in want.items():
        # the JAX graft: jnp.asarray(leaf, first-stage dtype)
        ref = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got[k], ref, err_msg=k)

    other = seeded_tree(jax.eval_shape(
        lambda x: AutoencoderKL(ch=64, ch_mult=(1, 1, 1, 1), num_res_blocks=1).init(
            jax.random.key(0), x), jnp.zeros((1, 64, 64, 3))))
    j_vae.save_vae(str(tmp_path / "other.msgpack"), other, dict(META, ch=64))
    with pytest.raises(ValueError, match="VAE arch mismatch"):
        t_train.graft_vae(port, str(tmp_path / "other.msgpack"))
