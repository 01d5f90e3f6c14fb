"""Write a port model's parameters as the JAX package's params export: an
Orbax StandardSave step directory, for tests and `chip_smoke.py` (a fixture
writer in the line of `make_flagship_ckpt.py`, not a feature of the CLIs).

    python -m morphablediffusion_torch.tools.make_orbax_run --out RUN/ckpt [--device cpu]

writes RUN/ckpt/params/1/ as orbax 0.11 lays one out, so that the JAX
package's `CheckpointManager(RUN/ckpt).restore_params` reads it back bit
for bit and the port's CLIs take `--ckpt RUN/ckpt`:

    _CHECKPOINT_METADATA      the step's metadata (orbax's JSON)
    default/_METADATA         every leaf's path and shape
    default/_sharding         every leaf on one device, JAX's CPU device
    default/manifest.ocdbt    one OCDBT manifest: one version, whose b-tree
                              root is one leaf node
    default/d/<id>            that node, and data files of at most
                              TARGET_DATA_FILE_BYTES of chunks

The tree is {'params': <the model's flax tree>} (`weights.to_jax_layout`),
each leaf one zarr v2 array of one chunk, compressed by libzstd
(`ZSTD_compress`, level 1, as orbax sets); `.zarray` values and chunks of at
most 1 024 bytes lie inline in the node, as orbax's config puts them. The
model is `Config()`'s with seeded weights (`weights.seeded_params`, seed 0,
the CLIs' `--ckpt random`), fp32, built on `--device` (default the CUDA
card).

`export_train_state(trainer, ckpt_dir)` writes a one-process Trainer's
state as the JAX train CLI's rolling checkpoint `last/<step>`, the
TrainState tree the JAX Trainer saves (`train_state_tree`; each leaf laid
out and compressed as it is written, so a full-width state is never held
on the host at once). `unpack_fixture` unpacks the committed JAX-written
run directory (written by the JAX package's own CheckpointManager; see
`FIXTURE`).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tarfile
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from morphablediffusion_torch.utils.orbax_reader import (CHECKPOINT_METADATA, MANIFEST_MAGIC,
                                                         NODE_MAGIC, THREADS, ZSTD, crc32c,
                                                         zstd)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# the JAX-written fixture (`fixture_config`): tests/orbax_fixture.py's run
# directory (tar.gz of `ckpt/{params,last}/3/`) and the sha256 of each leaf
# tensorstore read
FIXTURE = FIXTURES / "jax_orbax_tiny.tar.gz"
FIXTURE_LEAVES = FIXTURES / "jax_orbax_tiny.leaves.json"
FIXTURE_STEP = 3

MAX_INLINE_VALUE_BYTES = 1024         # orbax's OCDBT config
MAX_DECODED_NODE_BYTES = 100_000_000
TARGET_DATA_FILE_BYTES = 1 << 30
DEVICE = "TFRT_CPU_0"  # JAX's CPU device, where the repository runs JAX
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def fixture_config():
    """The fixture's configuration in the port: the tiny test configuration
    (`tools.common.tiny_config`, two views) widened as the training parity
    tests widen it (UNet width 64, volume dims 16 - 128: every GroupNorm
    group holds two channels or more), gradient accumulation 2."""
    from morphablediffusion_torch.tools.common import tiny_config

    cfg = tiny_config()
    cfg.model.unet.model_channels = 64
    cfg.model.unet.volume_dims = (16, 32, 64, 128)
    cfg.train.accumulate_grad_batches = 2
    return cfg


def unpack_fixture(dest) -> Path:
    """Unpack the committed JAX-written run directory into `dest`; returns
    its ckpt directory (holding params/3 and last/3)."""
    dest = Path(dest)
    with tarfile.open(FIXTURE, "r:gz") as tar:
        tar.extractall(dest, filter="data")
    return dest / "ckpt"


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _wrap(body: bytes, magic: int) -> bytes:
    """An OCDBT manifest or node: header, zstd body, CRC-32C footer."""
    comp = zstd().compress(np.frombuffer(body, np.uint8), level=0)
    head = _varint(0) + _varint(ZSTD)
    length = 4 + 8 + len(head) + len(comp) + 4
    raw = magic.to_bytes(4, "big") + length.to_bytes(8, "little") + head + comp
    return raw + crc32c(raw).to_bytes(4, "little")


def _file_table(paths) -> bytes:
    """A data-file table of one-level paths (no shared prefixes used)."""
    enc = [p.encode() for p in paths]
    return (_varint(len(enc)) + _varints([0] * max(len(enc) - 1, 0))
            + _varints(len(p) for p in enc) + _varints([0] * len(enc)) + b"".join(enc))


def _zarray(a: np.ndarray, dtype: str) -> bytes:
    meta = {"chunks": list(a.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(a.shape), "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def _no_data(leaf) -> bool:
    """A leaf orbax stores no array for: None (a masked moment, an empty
    optimizer state) or an empty tuple."""
    return leaf is None or isinstance(leaf, tuple)


def write_step(step_dir, tree: Dict[tuple, object]) -> int:
    """Write {path tuple (str keys, int sequence indices): leaf} as an Orbax
    StandardSave step directory. A leaf is a numpy array (fp32, or int32 /
    uint32 kept) or torch tensor (bf16 kept as bfloat16), or a function
    that returns one when it is written (so that a large tree need not be
    held in memory at once), or None / () (metadata alone, as orbax keeps a
    masked or empty state). Each array's sharding in `_sharding` is one
    device's, DEVICE (JAX's restore reads it when its target carries no
    sharding). Returns the bytes written."""
    step_dir = Path(step_dir)
    d = step_dir / "default"
    (d / "d").mkdir(parents=True, exist_ok=False)
    values, files, shapes, written = {}, [], {}, 0
    out = None

    def encode(item):
        path, leaf = item
        if callable(leaf):
            leaf = leaf()
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            a, dtype = leaf.detach().cpu().contiguous().view(torch.uint16).numpy(), "bfloat16"
        else:
            a = np.asarray(leaf)
            if a.dtype not in (np.int32, np.uint32):
                a = a.astype(np.float32, copy=False)
            a = np.require(a, requirements="C")  # (ascontiguousarray makes 0-D 1-D)
            dtype = a.dtype.str
        return path, a.shape, _zarray(a, dtype), zstd().compress(a, level=1)

    items = [(p, leaf) for p, leaf in tree.items() if not _no_data(leaf)]
    try:
        # libzstd releases the GIL: THREADS leaves compressed at once, a
        # batch at a time (the frames of one batch in memory)
        with ThreadPoolExecutor(max_workers=THREADS) as pool:
            frames = (f for lo in range(0, len(items), 4 * THREADS)
                      for f in pool.map(encode, items[lo:lo + 4 * THREADS]))
            for path, shape, zarray, frame in frames:
                shapes[path] = list(shape)
                name = ".".join(map(str, path))
                values[f"{name}/.zarray".encode()] = zarray
                key = f"{name}/{'.'.join(['0'] * len(shape)) or '0'}".encode()
                if len(frame) <= MAX_INLINE_VALUE_BYTES:
                    values[key] = frame
                    continue
                if out is None or out.tell() >= TARGET_DATA_FILE_BYTES:
                    if out is not None:
                        out.close()
                    files.append(f"d/{uuid.uuid4().hex}")
                    out = open(d / files[-1], "wb")
                values[key] = (len(files) - 1, out.tell(), len(frame))
                out.write(frame)
                written += len(frame)
    finally:
        if out is not None:
            out.close()

    # one b-tree leaf node, keys sorted, prefix-compressed
    keys = sorted(values)
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffix = [k[p:] for k, p in zip(keys, [0] + prefix)]
    refs = [values[k] for k in keys]
    inline = [v for v in refs if isinstance(v, bytes)]
    indirect = [v for v in refs if not isinstance(v, bytes)]
    node = (bytes([0]) + _file_table(files) + _varint(len(keys)) + _varints(prefix)
            + _varints(len(s) for s in suffix) + b"".join(suffix)
            + _varints(len(v) if isinstance(v, bytes) else v[2] for v in refs)
            + _varints(0 if isinstance(v, bytes) else 1 for v in refs)
            + _varints(v[0] for v in indirect) + _varints(v[1] for v in indirect)
            + b"".join(inline))
    node = _wrap(node, NODE_MAGIC)
    node_file = f"d/{uuid.uuid4().hex}"
    (d / node_file).write_bytes(node)
    now = time.time_ns()
    manifest = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES) + bytes([4]) + _varint(ZSTD)
                + (0).to_bytes(4, "little")  # zstd level
                + _file_table([node_file])
                + _varint(1) + _varint(1) + bytes([0])  # one version: generation 1, height 0
                + _varints([0, 0, len(node)])  # root: file, offset, length
                + _varints([len(keys), len(node), written])  # statistics
                + now.to_bytes(8, "little") + _varint(0))  # commit time; no version nodes
    (d / "manifest.ocdbt").write_bytes(_wrap(manifest, MANIFEST_MAGIC))

    def value_metadata(path, leaf):
        if _no_data(leaf):
            return {"value_type": "None" if leaf is None else "Tuple", "skip_deserialize": True}
        return {"value_type": "jax.Array", "skip_deserialize": False,
                "write_shape": shapes[path]}

    meta = {"tree_metadata": {
        str(tuple(map(str, path))): {
            "key_metadata": [{"key": str(k), "key_type": 1 if isinstance(k, int) else 2}
                             for k in path],
            "value_metadata": value_metadata(path, leaf)}
        for path, leaf in tree.items()},
        "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    (d / "_METADATA").write_text(json.dumps(meta))
    sharding = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": DEVICE})
    (d / "_sharding").write_text(json.dumps({
        base64.b64encode(".".join(map(str, path)).encode()).decode(): sharding
        for path in shapes}))
    (step_dir / CHECKPOINT_METADATA).write_text(json.dumps({
        "item_handlers": {"default": HANDLER}, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": now, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    return written + len(node)


def _jax_leaves(model: torch.nn.Module, prefix: tuple, get, keep=None) -> Dict[tuple, object]:
    """{prefix + flax path: leaf} for every parameter of `model`: the tensor
    `get(name, parameter)` (shaped like the parameter) in the JAX layout,
    made when it is written, bf16 kept; None where `keep(name)` is false (a
    masked moment)."""
    from morphablediffusion_torch import weights

    named = dict(model.named_parameters())
    out = {}
    for (name, p), path in zip(named.items(), weights.jax_shapes(model)):
        def leaf(name=name, p=p):
            t = get(name, p)
            a = next(iter(weights.to_jax_layout(model, {name: t}).values()))
            if t.dtype == torch.bfloat16:
                return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
            return a
        out[prefix + tuple(path.split("/"))] = leaf if keep is None or keep(name) else None
    return out


def export_params(model: torch.nn.Module, ckpt_dir, step: int) -> int:
    """`model`'s parameters as the params export `ckpt_dir/params/<step>`
    ({'params': flax tree}, fp32 as the model holds them, bf16 kept).
    Returns the bytes written."""
    tree = _jax_leaves(model, ("params",), lambda name, p: p)
    return write_step(Path(ckpt_dir) / "params" / str(step), tree)


def train_state_tree(trainer) -> Dict[tuple, object]:
    """A port Trainer's state (one process) as the JAX Trainer's TrainState,
    in the tree orbax writes for it (the fixture's `last/<step>` is one):

        step                         int32, the micro-steps taken
        params/params/...            the parameters (VAE and CLIP bf16)
        opt_state/...                with accumulate_grad_batches k > 1,
                                     optax.MultiSteps': mini_step (step mod
                                     k), gradient_step, acc_grads/params/...
                                     (the running mean of the gradients in
                                     the parameters' dtypes, zeros where no
                                     accumulation is under way), skip_state
                                     (); and inner_opt_state/ holding what
                                     stands at the top of opt_state for k = 1:
          inner_states/{base,cond}/inner_state/
            0/count, 0/mu/params/..., 0/nu/params/...
                                     AdamW's optimizer steps and moments
                                     (None for another group's parameters)
            1                        None (the weight decay keeps no state)
            2/count                  the schedule's optimizer steps
          inner_states/frozen/inner_state   None
        rng                          uint32[2]: `jax.random.key(train.seed)`,
                                     [0, seed] (the port's generator state
                                     has no JAX counterpart)
    """
    from morphablediffusion_torch.training.trainer import FROZEN

    if trainer.zero is not None:
        raise ValueError("train_state_tree writes a one-process Trainer's state")
    model, k, opt = trainer.model, trainer.accumulate, trainer.optimizer
    count = np.asarray(trainer.opt_step, np.int32)
    inner = {}
    for group in opt.param_groups:
        members = {id(p) for p in group["params"]}
        names = {n for n, p in model.named_parameters() if id(p) in members}
        pre = ("inner_states", group["name"], "inner_state")
        inner[pre + (0, "count")] = count
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            def get(name, p, key=key):  # zeros before the first optimizer step
                st = opt.state.get(p, {})
                return st[key] if key in st else torch.zeros_like(p, dtype=torch.float32)
            inner.update(_jax_leaves(model, pre + (0, moment, "params"), get, names.__contains__))
        inner[pre + (1,)] = None
        inner[pre + (2, "count")] = count
    inner[("inner_states", FROZEN, "inner_state")] = None

    tree = {("step",): np.asarray(trainer.step, np.int32)}
    tree.update(_jax_leaves(model, ("params", "params"), lambda name, p: p))
    if k > 1:
        acc = trainer._acc or {}
        tree[("opt_state", "mini_step")] = np.asarray(trainer.step % k, np.int32)
        tree[("opt_state", "gradient_step")] = count
        tree.update({("opt_state", "inner_opt_state") + path: leaf
                     for path, leaf in inner.items()})
        tree.update(_jax_leaves(model, ("opt_state", "acc_grads", "params"),
                                lambda name, p: acc[name] if name in acc
                                else torch.zeros_like(p)))
        tree[("opt_state", "skip_state")] = ()
    else:
        tree.update({("opt_state",) + path: leaf for path, leaf in inner.items()})
    tree[("rng",)] = np.asarray([0, trainer.config.train.seed], np.uint32)
    return tree


def export_train_state(trainer, ckpt_dir) -> int:
    """A port Trainer's state as the JAX train CLI's rolling checkpoint
    `ckpt_dir/last/<step>` (`train_state_tree`). Returns the bytes
    written."""
    return write_step(Path(ckpt_dir) / "last" / str(trainer.step), train_state_tree(trainer))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True, help="the run's ckpt directory")
    parser.add_argument("--device", default=None)
    flags = parser.parse_args(argv)

    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.utils import resolve_device
    from morphablediffusion_torch.utils.config import Config
    from morphablediffusion_torch.weights import seeded_params

    with torch.no_grad():
        model = seeded_params(MorphableDiffusion(Config().model,
                                                 device=resolve_device(flags.device)), 0)
    t0 = time.perf_counter()
    n = export_params(model, flags.out, 1)
    seconds = time.perf_counter() - t0
    print(json.dumps({"out": str(Path(flags.out) / "params" / "1"), "bytes": n,
                      "seconds": round(seconds, 3)}))


if __name__ == "__main__":
    main()
