"""Spans opened from the benchmark's own files, the profiler over the traced
window, and the reduction of its device trace to what the per-layer
readers take.

Spans are `torch.profiler.record_function` ranges: around each call and
each DDIM step or `train_step` (the driver), around the spatial-volume
and frustum construction (instance wrappers, the driver), and as forward
pre-hooks and hooks on modules (`module_spans`: the UNet, the VAE
decoder). The profiler writes each range a device-side twin
(`gpu_user_annotation`) spanning the kernels launched inside it; device
time under a span is the kernels inside its twins.

`kernel_group` is the port's `tools/profile_step.py::kernel_group`, copied.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
from collections import defaultdict

import numpy as np
import torch

from h100_bench.counts import SYMBOLS

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str, on: bool):
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class _Hooks:
    def __init__(self):
        self.handles = []

    def remove(self):
        for h in self.handles:
            h.remove()


def module_spans(modules: dict, on: bool) -> _Hooks:
    """A span named `name` around every forward of each module."""
    hooks = _Hooks()
    if not on:
        return hooks
    for name, mod in modules.items():
        stack = []

        def pre(_m, _a, name=name, stack=stack):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _a, _o, stack=stack):
            stack.pop().__exit__(None, None, None)

        hooks.handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return hooks


@contextlib.contextmanager
def profiled(on: bool):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def kernel_group(name: str) -> str:
    """The port's kernels by their own symbols, then PyTorch's SDPA, then the
    library groups (a copy of the port's `tools/profile_step.py`)."""
    low = name.lower()
    for key, group in (("md_ctx_wgmma_kernel", "K1 depth_attention_ctx (wgmma)"),
                       ("md_ctx_cluster_kernel", "K1 depth_attention_ctx (cluster)"),
                       ("depth_ctx_kernel", "K1 depth_attention_ctx (WMMA)"),
                       ("md_flash_fwd_kernel", "K2 flash_attention"),
                       ("md_flash_bwd_dkv_kernel", "K2-dkv flash_attention_bwd"),
                       ("md_flash_bwd_dq_kernel", "K2-dq flash_attention_bwd"),
                       ("md_depth_attn_kernel", "K3 depth_attention"),
                       ("md_group_norm_kernel", "K4 group_norm")):
        if key in name:
            return group
    if any(w in low for w in ("pytorch_flash", "fmha", "sdpa", "attention")):
        return "SDPA (PyTorch)"
    if any(w in low for w in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "matmul", "cublas")):
        return "matmul (cuBLAS)"
    if "grid_sampler" in low:
        return "grid_sample"
    if "reduce" in low or "norm" in low:
        return "reductions and norms"
    if any(w in low for w in ("adam", "foreach", "multi_tensor_apply")):
        return "optimizer (AdamW)"
    return "elementwise and other"


def union_s(starts, ends) -> float:
    """Seconds covered by the union of [start, end) intervals (ns)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[order], np.asarray(ends)[order]
    run_end = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    block_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    return float((block_end - s[idx]).sum()) / 1e9


def activity(e) -> str:
    """A kineto event's kind: 'kernel' (and the other device activities),
    'gpu_user_annotation', 'user_annotation', 'cuda_runtime' or 'cpu_op'
    (PyTorch builds without `activity_type` tell them apart by device and
    by `is_user_annotation`)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "gpu_memcpy" if "Memcpy" in e.name() or "Memset" in e.name() else "kernel"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def summarize(prof, window_s: float, device) -> dict:
    """Device kernels (name, start, end, group), the device-side extents of
    each span, the device's busy seconds and the breakdown of the traced
    window."""
    out = {"window_s": window_s, "busy_s": 0.0, "names": [], "start": np.zeros(0, np.int64),
           "end": np.zeros(0, np.int64), "group": [], "spans": {},
           "breakdown": {"device_ops": [], "idle_gaps": []}}
    if prof is None:
        return out
    names, start, end, corr = [], [], [], []
    spans = defaultdict(list)
    host_spans, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        act = activity(e)
        if act in DEVICE_ACTIVITIES:
            names.append(e.name())
            start.append(e.start_ns())
            end.append(e.start_ns() + e.duration_ns())
            corr.append(e.correlation_id())
        elif act == "gpu_user_annotation":
            spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif act == "user_annotation":
            host_spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif act == "cuda_runtime":
            launches[e.correlation_id()] = e.start_ns()
    if not names:
        return out
    order = np.argsort(start, kind="stable")
    start = np.asarray(start, np.int64)[order]
    end = np.asarray(end, np.int64)[order]
    names = [names[i] for i in order]
    corr = [corr[i] for i in order]
    groups = [kernel_group(n) for n in names]
    out.update(names=names, start=start, end=end, group=groups,
               spans={k: sorted(v) for k, v in spans.items()},
               busy_s=union_s(start, end))
    out["breakdown"] = breakdown(names, start, end, corr, launches, host_spans)
    return out


def breakdown(names, start, end, corr, launches, host_spans, top: int = 10):
    """The device operations that took most time, and the idle gaps before
    a kernel by the innermost benchmark span open on the host when that
    kernel was launched."""
    by_name = defaultdict(float)
    for n, s, e in zip(names, start, end):
        by_name[n[:64]] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host_spans = sorted(host_spans)
    starts = [h[0] for h in host_spans]
    run_end = np.maximum.accumulate(end)
    gaps = defaultdict(float)
    for i in range(1, len(start)):
        gap = start[i] - run_end[i - 1]
        if gap <= 0:
            continue
        t = launches.get(corr[i], start[i])
        j = bisect.bisect_right(starts, t) - 1
        label = "outside spans"
        while j >= 0:
            if host_spans[j][1] >= t:
                label = host_spans[j][2]
                break
            j -= 1
        gaps[label] += gap / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def inside(summary, span_name: str):
    """Boolean mask of the kernels that lie inside a device-side twin of
    the span."""
    s, e = summary["start"], summary["end"]
    mask = np.zeros(len(s), bool)
    for a, b in summary["spans"].get(span_name, []):
        lo, hi = np.searchsorted(s, a, "left"), np.searchsorted(s, b, "right")
        mask[lo:hi] |= e[lo:hi] <= b
    return mask


def step_regions(summary):
    """Mask of the kernels from each call's first step span to its last
    (the DDIM updates between the steps included)."""
    steps = summary["spans"].get("step", []) or summary["spans"].get("train_step", [])
    calls = summary["spans"].get("call", [])
    regions = []
    if summary["kind"] == "train":
        regions = steps
    else:
        for a, b in calls:
            inner = [st for st in steps if st[0] >= a and st[1] <= b]
            if inner:
                regions.append((inner[0][0], inner[-1][1]))
    s, e = summary["start"], summary["end"]
    mask = np.zeros(len(s), bool)
    for a, b in regions:
        lo, hi = np.searchsorted(s, a, "left"), np.searchsorted(s, b, "right")
        mask[lo:hi] |= e[lo:hi] <= b
    return mask


def ms_per_step(summary, mask) -> float | None:
    if summary["steps"] == 0 or not mask.any():
        return None
    return float((summary["end"][mask] - summary["start"][mask]).sum()) / 1e6 / summary["steps"]


def report_launch_mismatch(summary) -> None:
    """Print, for each hand-written kernel, the trace's record count beside
    the launches the program counted over the same window, where they
    differ."""
    for kernel, launched in sorted(summary["launches"].items()):
        key = SYMBOLS.get(kernel)
        if key is None or not launched:
            continue
        seen = sum(1 for n in summary["names"] if key in n)
        summary.setdefault("matched", {})[kernel] = seen == launched
        if seen != launched:
            print(f"trace records of {kernel} ({key}): {seen}, launches counted: {launched}",
                  file=sys.stderr)
