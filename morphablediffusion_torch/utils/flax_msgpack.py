"""A reader of the JAX package's flax-msgpack weight files, without flax.

The JAX package writes its small weight files with flax's serializer
(`flax.serialization.to_bytes` / `msgpack_serialize`): the shipped landmark
net `artifacts/landmark_net_synth.msgpack` and `apps/train_vae`'s first
stage. That format is a subset of msgpack:

  * maps (fixmap, map16, map32) with string keys, arrays (fixarray,
    array16, array32), strings, binaries, nil, booleans, integers and
    float32/64;
  * ext type 1, an ndarray: a nested msgpack array (shape, dtype name,
    C-order bytes). `bfloat16` is named as such; numpy has no bf16, so such
    a leaf becomes a `torch.bfloat16` tensor (`torch.frombuffer`), every
    other leaf a numpy array;
  * ext type 2, a Python complex: a nested (real, imag);
  * ext type 3, a numpy scalar: an ndarray of shape () unpacked to its
    scalar (a 0-d bf16 tensor for bfloat16);
  * leaves over `flax.serialization.MAX_CHUNK_SIZE` bytes are written as
    `{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
    {"0": ..}}` dicts; they are joined back as flax's `msgpack_restore`
    does (in dict values and at the top, not inside lists).

`restore` gives the tree `flax.serialization.msgpack_restore` gives, leaf
for leaf and bit for bit (arrays as lists, string keys). Any other ext
code, a msgpack type outside the subset, a truncated file or trailing bytes
raise `ValueError`: no partial tree is returned.

    tree = restore("artifacts/landmark_net_synth.msgpack")
    flat = flatten(tree["params"]["params"])  # {"Conv_0/kernel": array, ...}
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # code -> (struct format, size) of the fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """One msgpack object from `data`; raw=True reads strings as bytes (the
    form the ndarray ext's inner array is read in)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"flax msgpack: truncated at byte {self.pos} (wanted {n} more "
                             f"of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def read(self) -> Any:
        c = self.uint(1)
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.string(c & 0x1F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):  # bin8/16/32
            return bytes(self.take(self.uint(1 << (c - 0xC4))))
        if c in (0xC7, 0xC8, 0xC9):  # ext8/16/32
            n = self.uint(1 << (c - 0xC7))
            return self.ext(n)
        if c in _FIXED:
            fmt, size = _FIXED[c]
            return struct.unpack(fmt, self.take(size))[0]
        if c in _FIXEXT:
            return self.ext(_FIXEXT[c])
        if c in (0xD9, 0xDA, 0xDB):  # str8/16/32
            return self.string(self.uint(1 << (c - 0xD9)))
        if c in (0xDC, 0xDD):  # array16/32
            return [self.read() for _ in range(self.uint(2 if c == 0xDC else 4))]
        if c in (0xDE, 0xDF):  # map16/32
            return self.map(self.uint(2 if c == 0xDE else 4))
        raise ValueError(f"flax msgpack: type byte 0x{c:02x} at byte {self.pos - 1} is not "
                         "in the subset flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"flax msgpack: map key {k!r} is not a string")
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_COMPLEX:
            re_, im = _whole(payload, raw=False)
            return complex(re_, im)
        if code == EXT_NPSCALAR:
            a = _ndarray(payload)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"flax msgpack: ext type {code} is not one flax writes (1, 2, 3)")


def _whole(data, raw: bool) -> Any:
    """Exactly one msgpack object in `data`, else ValueError."""
    r = _Reader(data, raw=raw)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"flax msgpack: {len(r.data) - r.pos} trailing bytes after the object")
    return out


def _ndarray(payload):
    """flax's ndarray ext: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = _whole(payload, raw=True)
    shape = tuple(int(s) for s in shape)
    name = name.decode("ascii") if isinstance(name, bytes) else name
    buf = bytearray(buf)  # writable, so torch takes it without a warning
    if name == "bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"flax msgpack: unknown dtype {name!r}") from e
    if dtype.hasobject:
        raise ValueError(f"flax msgpack: object dtype {name!r}")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's `_unchunk_array_leaves_in_place`: chunked dicts at the top and
    in dict values, recursively (not inside lists)."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return d


def loads(data: bytes) -> Any:
    """The tree of a flax-msgpack byte string (see the module docstring)."""
    return _unchunk_leaves(_whole(data, raw=False))


def restore(path) -> Any:
    """The tree of a flax-msgpack file: nested dicts (and lists) of numpy
    arrays, bf16 torch tensors and Python scalars."""
    return loads(Path(path).read_bytes())


def is_torch_file(path) -> bool:
    """Whether `path` is a `torch.save` zip (it starts `PK\\x03\\x04`), by
    content, not by suffix."""
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {'a/b/c': numpy array}, the form the port's
    `from_jax_params` bridges take; a bf16 leaf becomes fp32 (exact)."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, path))
        elif isinstance(v, torch.Tensor):
            flat[path] = v.float().numpy()
        else:
            flat[path] = np.asarray(v)
    return flat
