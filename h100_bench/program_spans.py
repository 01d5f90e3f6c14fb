"""The port's own spans in the traced window, and the device work launched
inside them.

The port opens `md.*` spans at its layer boundaries
(`morphablediffusion_torch/utils/spans.py`): host ranges on the
profiler's clock (`cpu_op` records), not user annotations, so they have no
device-side twin and take no kernel from the benchmark's own spans. A
kernel belongs to a program span when its launch (the CUDA runtime or
driver record that shares the kernel's correlation id) falls inside one of
that span's host ranges, on any thread: the backward's kernels, which
autograd's device thread launches while `md.backward` is open on the main
thread, count under `md.backward`. The idle gap before a kernel, as
`trace.breakdown` measures it, is charged to the spans its launch falls
in. A kernel with no launch record is charged to no program span.

The driver hands a reader the summary alone (`trace.summarize`), and the
summary holds neither the host ranges of `cpu_op` records nor launch
times. `of(summary)` reads them from the profiler the summary was made
from: the local `prof` of a calling frame (`driver.run_serving`,
`driver.run_training`), parsed once per summary.
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from h100_bench.trace import DEVICE_ACTIVITIES, activity

PREFIX = "md."
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")
ALLOCATOR_CALLS = ("cudaMalloc", "cudaFree")

def _profiler_of_callers():
    frame = sys._getframe(1)
    while frame is not None:
        prof = frame.f_locals.get("prof")
        results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
        if results is not None:
            return results
        frame = frame.f_back
    return None


def _union(intervals):
    """Sorted, disjoint (starts, ends) arrays covering the intervals."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if starts and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def parse(results) -> dict:
    """From the profiler's kineto results: the device records in the
    summary's order (by start) with their launch times (-1 without a
    launch record), each `md.*` span's host ranges, and the start times of
    the CUDA runtime's `cudaMalloc` and `cudaFree` records."""
    start, end, corr = [], [], []
    ranges = defaultdict(list)
    launches, allocator = {}, []
    for e in results.events():
        act = activity(e)
        if act in DEVICE_ACTIVITIES:
            start.append(e.start_ns())
            end.append(e.start_ns() + e.duration_ns())
            corr.append(e.correlation_id())
        elif act == "cpu_op":
            name = e.name()
            if name.startswith(PREFIX):
                ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif act in LAUNCH_ACTIVITIES:
            if e.name() in ALLOCATOR_CALLS:
                allocator.append(e.start_ns())
            else:
                launches[e.correlation_id()] = e.start_ns()
    order = np.argsort(start, kind="stable")
    start = np.asarray(start, np.int64)[order]
    end = np.asarray(end, np.int64)[order]
    launch = np.asarray([launches.get(corr[i], -1) for i in order], np.int64)
    return {"start": start, "end": end, "launch": launch,
            "ranges": {k: _union(v) for k, v in ranges.items()},
            "allocator": np.sort(np.asarray(allocator, np.int64))}


def of(summary):
    """The parse of the trace `summary` was made from, or None where no
    profiler is found, the trace holds no device record or its device
    records are not the summary's. The first reader's call keeps it in the
    summary under "program" for the others."""
    if "program" not in summary:
        results = _profiler_of_callers() if len(summary["start"]) else None
        p = parse(results) if results is not None else None
        if p is not None and not np.array_equal(p["start"], summary["start"]):
            p = None
        summary["program"] = p
    return summary["program"]


def within(times, span_ranges):
    """Mask of the times that lie inside one of the ranges."""
    starts, ends = span_ranges
    j = np.searchsorted(starts, times, "right") - 1
    ok = j >= 0
    ok[ok] = times[ok] <= ends[j[ok]]
    return ok


def launched_in(p, name: str):
    """Mask of the device records launched inside the span, or None where
    the span was never opened."""
    if name not in p["ranges"]:
        return None
    return within(p["launch"], p["ranges"][name]) & (p["launch"] >= 0)


def device_ms(summary, name: str, per: str = "steps"):
    """Device ms of the records launched inside the span, per step (or per
    call); None where the span or its records are absent."""
    p = of(summary)
    if p is None or not summary.get(per):
        return None
    mask = launched_in(p, name)
    if mask is None or not mask.any():
        return None
    return float((p["end"][mask] - p["start"][mask]).sum()) / 1e6 / summary[per]


def idle_ms(summary, name: str):
    """Idle ms per step before the records launched inside the span: the
    time from the end of all earlier device work to the record's start."""
    p = of(summary)
    if p is None or not summary.get("steps"):
        return None
    mask = launched_in(p, name)
    if mask is None or not mask.any():
        return None
    run_end = np.maximum.accumulate(p["end"])
    gap = np.zeros(len(p["start"]), np.int64)
    gap[1:] = np.maximum(p["start"][1:] - run_end[:-1], 0)
    return float(gap[mask].sum()) / 1e6 / summary["steps"]


def allocator_calls(summary, name: str):
    """The CUDA runtime's cudaMalloc and cudaFree records inside the span,
    per step; None where the span is absent."""
    p = of(summary)
    if p is None or not summary.get("steps") or name not in p["ranges"]:
        return None
    return float(within(p["allocator"], p["ranges"][name]).sum()) / summary["steps"]
