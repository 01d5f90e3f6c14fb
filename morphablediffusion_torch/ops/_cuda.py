"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source under `morphablediffusion_torch/csrc/` is compiled with
`nvcc` for Hopper (`sm_90a`) into its own shared library with a plain C
interface, at first use, into `build/torch_kernels/` at the repository root,
and loaded with `ctypes`. A source may hold several entry points (one
`CudaKernel` each, each with its own launch count); it is built once.
Library names carry a hash of the source, the headers beside it and the
flags, so an edited source or header is rebuilt. Nothing is compiled or
loaded when a module is imported: the CPU tests import every module.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `CudaKernel.launch` raises on a non-zero code and
counts the launches that were made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


class CudaKernel:
    """One kernel source, its C entry point, and a count of its launches.

    `launches` is incremented once for every kernel launch made through
    `launch`, and nowhere else.
    """

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None
        self._err = None

    def lib_path(self) -> Path:
        """The library's path, named by a hash of the source, of every
        header (`*.cuh`) beside it, which a source may include, and of the
        flags: an edit to any of them leads to a new build."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def _load(self):
        if self._fn is None:
            build([self])
            lib = ctypes.CDLL(str(self.lib_path()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.md_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args):
        """Call the C entry point; raise if the launch reported an error."""
        code = self._load()(*args)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code} ({msg})")
        self.launches += 1


def build(kernels) -> None:
    """Compile every kernel whose library is missing, one nvcc per source,
    all started together; wait for all of them and raise if any failed."""
    todo = {}
    for k in kernels:
        if not k.lib_path().exists():
            todo.setdefault(k.lib_path(), []).append(k)
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for lib, ks in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(ks[0].source)]
            procs.append((ks, lib, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for ks, lib, tmp, t0, p in procs:
            log = p.communicate()[0]
            for k in ks:
                k.build_log, k.build_seconds = log, time.perf_counter() - t0
            if p.returncode != 0:
                failed.append(f"nvcc failed for {ks[0].source}:\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def ptr(t: torch.Tensor) -> int:
    """A tensor's address, for an entry point's `ctypes.c_void_p` argument
    (ctypes converts the int; a wrapper object would cost a microsecond a
    pointer on the launch path)."""
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as a `c_void_p` argument."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor,
               device: torch.device | None = None) -> None:
    """Raise unless every tensor is a contiguous `dtype` tensor on the CUDA
    device `device` (default: that of the first one)."""
    dev = tensors[0].device if device is None else device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: the kernel takes {dtype}, got {t.dtype}")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts 16-byte aligned, as a TMA tensor map
    needs."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (TMA)")


def needs_autograd(*tensors) -> bool:
    """Whether autograd records an op on these inputs (None for an absent
    one): grad mode is on and one of them requires a gradient. A wrapper
    that finds no need launches its kernel without an autograd Function."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def recompute_grads(fn, inputs, needs, grad_out):
    """Gradients of fn(*inputs) for the inputs that need one (None for the
    others and for inputs that are None), recomputed through fn, a kernel's
    plain version: the backward of the kernels' autograd Functions. The
    cotangent is cast to the recomputed output's dtype (the kernel's output
    may differ from it)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)
