"""Named ranges at the port's layer boundaries, on the profiler's clock.

    with spans.span("md.decode"):
        ...

While a `torch.profiler` session records, `span(name)` is a
`_RecordFunctionFast` range: a host range named `name` in the trace (a
`cpu_op`, not a user annotation, so the device-side twins of the caller's
own `record_function` ranges keep their kernels). Otherwise it is one
shared no-op context: no allocation, no clock read, no record. The
profiler is the only switch.

A span writes nothing to the device, synchronizes nothing and changes no
number; it goes outside `torch.utils.checkpoint`, never inside a
checkpointed function. Every name starts with `md.`.

`counters()` is a snapshot of the caching allocator's calls to the CUDA
runtime: `cudaMalloc` and `cudaFree` (its segments allocated and freed)
and its retries after a failed `cudaMalloc`.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named host range while the profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def counters(device=None) -> Dict[str, int]:
    """{"cuda_malloc", "cuda_free", "alloc_retries"}: the caching
    allocator's counts on `device` (default the current card) since the
    process started; zeros off CUDA."""
    on_card = device is None or torch.device(device).type == "cuda"
    if not (on_card and torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {"cuda_malloc": 0, "cuda_free": 0, "alloc_retries": 0}
    stats = torch.cuda.memory_stats(device)
    return {"cuda_malloc": int(stats.get("segment.all.allocated", 0)),
            "cuda_free": int(stats.get("segment.all.freed", 0)),
            "alloc_retries": int(stats.get("num_alloc_retries", 0))}
