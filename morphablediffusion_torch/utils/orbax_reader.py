"""A reader of the JAX package's Orbax checkpoints, without JAX.

The JAX train CLI writes its runs with orbax's `CheckpointManager` and
`StandardSave` (orbax 0.11: an OCDBT database of zarr v2 arrays):

    <ckpt_dir>/{last,params,snapshots}/<step>/_CHECKPOINT_METADATA
    <ckpt_dir>/{last,params,snapshots}/<step>/default/
        _METADATA          JSON: each leaf's path (`key_metadata`) and shape
        manifest.ocdbt     the root OCDBT manifest
        d/<id>             data files: b-tree nodes, and values
        ocdbt.process_0/   the writing process's database, whose data files
                           the root's b-tree points into

`last/` holds the whole TrainState, `params/` the params export. The newest
step is the largest integer-named directory that holds
`_CHECKPOINT_METADATA` (`latest_step`); unfinished `*.orbax-checkpoint-tmp*`
directories are skipped.

OCDBT, tensorstore's b-tree key-value store (its published format
description): a manifest or a b-tree node is a file, or a piece of a data
file, made of a header (a magic number, 4 bytes big-endian; the total
length, 8 bytes little-endian; the format version and the compression,
varints, 1 = zstd), a body (one zstd frame) and a CRC-32C of everything
before it (4 bytes little-endian). The manifest holds the database's config
and its newest versions, each the location of a b-tree root. A node names
the data files it points into in a table of paths relative to the
database's directory. An interior node holds, per child, its first key, the
length of the prefix all the child's keys share (which the child stores
without), the child's location and statistics; a leaf holds keys and values,
each value inline or a (data file, offset, length) reference. Keys are
prefix-compressed within a node; integers are LEB128 varints.

Keys are zarr v2 arrays: `<dot-joined path>/.zarray` (JSON: shape, chunks,
dtype, compressor zstd, C order, fill_value) and the chunks, keyed by their
grid indices joined by the dimension separator (`0` for a 0-d array), each
a bare zstd frame of C-order bytes; a chunk that is missing holds
`fill_value` (0 when null). A leaf's key is built from `_METADATA`'s
`key_metadata`, never by splitting a stored key on '.'. numpy has no
bfloat16, so such a leaf comes back as a `torch.bfloat16` tensor (a uint16
view of its bytes), every other leaf as a numpy array.

zstd is the system's libzstd through ctypes: there is no other decoder. A
missing library, a CRC mismatch, an unknown format version or manifest
kind, a missing key or an unsupported dtype raise.

    tree = read_tree("runs/x/ckpt/params/2000")  # {('params', 'unet', ...): array}
    flat = flat_params(tree)                     # {'unet/.../kernel': array}
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_COMPRESSION, ZSTD = 0, 1
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_STEP_DIR = re.compile(r"^\d+$")
_UNKNOWN_SIZE = (1 << 64) - 1, (1 << 64) - 2  # ZSTD_CONTENTSIZE_UNKNOWN, _ERROR
THREADS = min(8, os.cpu_count() or 1)  # leaves read (or compressed) at once


# --------------------------------------------------------------------- zstd


class Zstd:
    """libzstd through ctypes: `decompress_into` a buffer of known size,
    `decompress` a frame of unknown size, `compress` (the fixture writer)."""

    def __init__(self):
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise OSError("libzstd (libzstd.so.1) is needed to read Orbax checkpoints "
                          f"and could not be loaded: {e}") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for fn, res, args in (
                ("ZSTD_versionNumber", ctypes.c_uint, []),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_compressBound", size_t, [size_t]),
                ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int])):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        self.lib = lib
        self.version = lib.ZSTD_versionNumber()
        self.path = _mapped_path("libzstd") or name

    def _check(self, r: int, what: str) -> int:
        if self.lib.ZSTD_isError(r):
            raise ValueError(f"zstd {what}: {self.lib.ZSTD_getErrorName(r).decode()}")
        return r

    def decompress_into(self, src: bytes, dst: np.ndarray) -> None:
        """Decode one frame into the C-contiguous `dst`, which it must fill."""
        n = self._check(self.lib.ZSTD_decompress(dst.ctypes.data, dst.nbytes, src, len(src)),
                        "decompress")
        if n != dst.nbytes:
            raise ValueError(f"zstd frame decoded to {n} bytes, expected {dst.nbytes}")

    def decompress(self, src: bytes, limit: int = 1 << 31) -> bytes:
        """Decode one frame whose size the frame may not record."""
        size = self.lib.ZSTD_getFrameContentSize(src, len(src))
        cap = size if size not in _UNKNOWN_SIZE else max(1 << 16, 8 * len(src))
        while True:
            dst = ctypes.create_string_buffer(max(cap, 1))
            r = self.lib.ZSTD_decompress(dst, cap, src, len(src))
            if not self.lib.ZSTD_isError(r):
                return dst.raw[:r]
            if b"too small" not in self.lib.ZSTD_getErrorName(r) or cap >= limit:
                self._check(r, "decompress")
            cap = min(2 * cap, limit)

    def compress(self, src: np.ndarray, level: int = 1) -> bytes:
        src = np.ascontiguousarray(src)
        cap = self.lib.ZSTD_compressBound(src.nbytes)
        dst = ctypes.create_string_buffer(cap)
        n = self._check(self.lib.ZSTD_compress(dst, cap, src.ctypes.data, src.nbytes, level),
                        "compress")
        return dst.raw[:n]


def _mapped_path(stem: str) -> Optional[str]:
    """The file of a loaded shared library whose name starts with `stem`."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if os.path.basename(path).startswith(stem):
                    return path
    except OSError:
        pass
    return None


_ZSTD: Optional[Zstd] = None


def zstd() -> Zstd:
    """The process's libzstd, loaded at first use."""
    global _ZSTD
    if _ZSTD is None:
        _ZSTD = Zstd()
    return _ZSTD


# ------------------------------------------------------------------ CRC-32C


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's footers hold it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -------------------------------------------------------------------- OCDBT


class _Cursor:
    """Reads the fields of a decoded manifest or node body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        r = shift = 0
        while True:
            c = self.u8()
            r |= (c & 0x7F) << shift
            if c < 0x80:
                return r
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int):
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """Header, CRC and compression of one OCDBT manifest or node -> its body."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "b-tree node"
        raise ValueError(f"{what}: not an OCDBT {kind}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: header length {length}, {len(raw)} bytes read")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} (0 is read)")
    body = raw[cur.pos:-4]
    if compression == ZSTD:
        return zstd().decompress(body)
    if compression != NO_COMPRESSION:
        raise ValueError(f"{what}: compression {compression}")
    return body


def _data_files(cur: _Cursor):
    """A data-file table: paths relative to the database's directory."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base-path lengths: the paths are used whole
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


def _keys(cur: _Cursor, n: int, common: bool):
    """n prefix-compressed keys (and, in an interior node, each child's
    common-prefix length)."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    shared = cur.varints(n) if common else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, shared


class Value:
    """A stored value: inline bytes, or `length` bytes at `offset` of a data file."""

    __slots__ = ("inline", "path", "offset", "length")

    def __init__(self, inline=None, path=None, offset=0, length=0):
        self.inline, self.path, self.offset, self.length = inline, path, offset, length

    def read(self) -> bytes:
        if self.inline is not None:
            return self.inline
        with open(self.path, "rb") as f:
            data = os.pread(f.fileno(), self.length, self.offset)
        if len(data) != self.length:
            raise ValueError(f"{self.path}: {len(data)} of {self.length} bytes at "
                             f"{self.offset}")
        return data


class OcdbtDatabase:
    """The newest version of the OCDBT database in `root` (the directory of
    its `manifest.ocdbt`): `keys` maps every key to its `Value`."""

    def __init__(self, root):
        self.root = Path(root)
        what = str(self.root / "manifest.ocdbt")
        cur = _Cursor(_unwrap((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC,
                              what), what)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (single, 0, is read)")
        cur.varint(), cur.varint(), cur.u8()  # max inline, max node bytes, arity
        if cur.varint() == ZSTD:
            cur.take(4)  # level
        files = _data_files(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{what}: no version")
        generation, height = cur.varints(n), [cur.u8() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self.height = height[newest]  # of the b-tree: 0 for a root that is a leaf
        self.keys: Dict[bytes, Value] = {}
        if length[newest] != (1 << 64) - 1:  # else an empty tree
            self._walk(files[file_id[newest]], offset[newest], length[newest],
                       height[newest], b"")

    def _node(self, rel: str, offset: int, length: int) -> _Cursor:
        path = self.root / rel
        raw = Value(path=path, offset=offset, length=length).read()
        what = f"{path}@{offset}"
        return _Cursor(_unwrap(raw, NODE_MAGIC, what), what)

    def _walk(self, rel, offset, length, height, prefix: bytes) -> None:
        cur = self._node(rel, offset, length)
        if cur.u8() != height:
            raise ValueError(f"{cur.what}: height is not the {height} its parent gives")
        files = _data_files(cur)
        n = cur.varint()
        keys, shared = _keys(cur, n, common=height > 0)
        if height > 0:
            file_id, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            for k, s, f, o, ln in zip(keys, shared, file_id, offs, lens):
                self._walk(files[f], o, ln, height - 1, prefix + k[:s])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{cur.what}: value kind {max(kinds)}")
        file_id, offs = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_id, offs)))
        for i, (k, ln) in enumerate(zip(keys, lengths)):
            if i in refs:
                f, o = refs[i]
                self.keys[prefix + k] = Value(path=self.root / files[f], offset=o, length=ln)
            else:
                self.keys[prefix + k] = Value(inline=cur.take(ln))

    def get(self, key: str) -> Optional[Value]:
        return self.keys.get(key.encode())


# ------------------------------------------------------------------ zarr v2


def _zarr_dtype(name: str) -> Tuple[np.dtype, bool]:
    """zarr v2 dtype string -> (numpy storage dtype, is bfloat16)."""
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    dt = np.dtype(name)
    if dt.byteorder == ">" or dt.kind not in "biuf":
        raise ValueError(f"zarr dtype {name!r} is not read")
    return dt, False


def _fill(fill, bf16: bool):
    """A chunk that is missing holds `fill_value` (null: 0)."""
    if fill is None:
        return 0
    if bf16:  # the top half of the fp32 value's bits
        return int(np.array(float(fill), np.float32).view(np.uint32)) >> 16
    return fill


def read_array(db: OcdbtDatabase, name: str):
    """The zarr v2 array stored under `name` in `db`."""
    zarray = db.get(f"{name}/.zarray")
    if zarray is None:
        raise KeyError(f"{db.root}: no array {name!r}")
    meta = json.loads(zarray.read())
    comp = meta.get("compressor")
    if (meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters")
            or (comp is not None and comp.get("id") != "zstd")):
        raise ValueError(f"{name}: zarr array {meta} is not read")
    dt, bf16 = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dt)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = sep.join(map(str, idx)) if shape else "0"
        lo = [i * c for i, c in zip(idx, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        value = db.get(f"{name}/{key}")
        if value is None:
            out[region] = _fill(fill, bf16)
            continue
        data = value.read()
        whole = tuple(chunks) == shape
        buf = out if whole else np.empty(chunks, dt)
        if comp is None:
            if len(data) != buf.nbytes:
                raise ValueError(f"{name}/{key}: {len(data)} bytes, expected {buf.nbytes}")
            buf.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            zstd().decompress_into(data, buf)
        if not whole:
            out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------- checkpoints


def step_dir_of(path) -> Path:
    """`<step>` or `<step>/default` -> the directory holding `_METADATA`."""
    path = Path(path)
    for d in (path / "default", path):
        if (d / "_METADATA").is_file():
            return d
    raise FileNotFoundError(f"{path}: no Orbax _METADATA (neither {path}/default/_METADATA "
                            "nor _METADATA)")


def latest_step(kind_dir) -> Optional[int]:
    """The newest finished step under an orbax CheckpointManager directory
    (`last/`, `params/`, `snapshots/`), or None."""
    kind_dir = Path(kind_dir)
    if not kind_dir.is_dir():
        return None
    steps = [int(d.name) for d in kind_dir.iterdir()
             if _STEP_DIR.match(d.name) and (d / CHECKPOINT_METADATA).is_file()]
    return max(steps, default=None)


def _path_key(entry) -> object:
    # key_type 1 is a sequence index, 2 a dict key or attribute name
    return int(entry["key"]) if entry["key_type"] == 1 else str(entry["key"])


class StepTree:
    """An Orbax StandardSave step directory opened once (its `_METADATA` and
    OCDBT database): `paths` are its array leaves' paths (str keys, int
    sequence indices), `read(prefix)` reads those under `prefix`."""

    def __init__(self, step_dir):
        d = step_dir_of(step_dir)
        meta = json.loads((d / "_METADATA").read_text())
        if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
            raise ValueError(f"{d}: only OCDBT with zarr v2 is read")
        self.db = OcdbtDatabase(d)
        self.paths = []
        for entry in meta["tree_metadata"].values():
            value_type = entry["value_metadata"].get("value_type")
            if entry["value_metadata"].get("skip_deserialize"):
                continue  # no data: a masked moment (None), an empty state (Tuple)
            path = tuple(_path_key(k) for k in entry["key_metadata"])
            if value_type not in ("jax.Array", "np.ndarray", "scalar"):
                raise ValueError(f"{d}: leaf {path} of type {value_type!r} is not read")
            self.paths.append(path)

    def __contains__(self, path) -> bool:
        return path in self.paths

    def read(self, prefix: tuple = ()) -> Dict[tuple, object]:
        """{path: numpy array, or a torch.bfloat16 tensor} of the leaves
        under `prefix`."""
        paths = [p for p in self.paths if p[:len(prefix)] == prefix]
        # pread and libzstd release the GIL: leaves are read THREADS at a time
        with ThreadPoolExecutor(max_workers=max(1, min(THREADS, len(paths)))) as pool:
            arrays = list(pool.map(lambda p: read_array(self.db, ".".join(map(str, p))), paths))
        return dict(zip(paths, arrays))


def read_tree(step_dir, prefix: tuple = ()) -> Dict[tuple, object]:
    """Every array leaf of an Orbax StandardSave step directory (only those
    under `prefix` if given): {path tuple (str keys, int sequence indices):
    numpy array, or a torch.bfloat16 tensor}."""
    return StepTree(step_dir).read(prefix)


def flat_params(tree: Dict[tuple, object], prefix: tuple = ("params",)) -> Dict[str, object]:
    """{'a/b': leaf} of the leaves under `prefix` (by default the top-level
    'params' collection of a params export), the form
    `weights.from_jax_params` takes."""
    n = len(prefix)
    return {"/".join(map(str, p[n:])): v for p, v in tree.items() if p[:n] == prefix}
