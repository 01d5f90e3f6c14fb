"""The readers of the port's own spans (`program_spans.py`) on hand-made
traces: each reads what its span launched, a kernel launched from a
second thread inside `md.backward` counts there, a reader whose span is
absent reads nothing, and the port's spans change neither the summary nor
the readings of the benchmark's earlier readers."""

from __future__ import annotations

import numpy as np
import pytest

from h100_bench import driver, program_spans, trace

MS = 1_000_000  # ns

NEW_SERVE = ["decode_ms.serve", "conditioner_ms.serve", "resblock_ms.serve", "attn_ms.serve",
             "depth_attn_ms.serve"]
NEW_TRAIN = ["encode_ms.train", "backward_ms.train", "forward_idle_ms.train",
             "backward_idle_ms.train", "update_idle_ms.train", "allocator_calls_per_step.train"]
EARLIER = ["step_busy_ms.serve", "kernels_per_step.serve", "volume_ms.serve", "unet_ms.serve",
           "elementwise_ms.serve", "step_busy_ms.train", "optimizer_ms.train",
           "kernel_roofline.serve", "kernel_roofline.train", "idle_share.serve",
           "idle_share.train", "mfu.serve", "mfu.train"]


class Event:
    def __init__(self, kind, name, start, end, corr=0, thread=1):
        self.kind, self._name, self.start, self.end = kind, name, start, end
        self.corr, self.thread = corr, thread

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.thread


class Prof:
    """What `trace.summarize` and `program_spans` read of a profiler."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: list(events)})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def kernels(spec):
    """(name, launch ms, start ms, end ms[, launching thread]) -> kernel and
    launch records, with the twin of each benchmark span they fall in."""
    out = []
    for i, (name, launch, a, b, *thread) in enumerate(spec, start=1):
        out.append(Event("kernel", name, a * MS, b * MS, corr=i))
        out.append(Event("cuda_runtime", "cudaLaunchKernel", launch * MS, launch * MS + 5000,
                         corr=i, thread=thread[0] if thread else 1))
    return out


def host(kind, name, a, b):
    return Event(kind, name, a * MS, b * MS)


def twins(name, spec):
    return [Event("gpu_user_annotation", name, min(k[2] for k in spec) * MS,
                  max(k[3] for k in spec) * MS)]


TRAIN_KERNELS = [("vae_conv", 3, 10, 30), ("elementwise_kernel", 25, 35, 40),
                 ("unet_conv", 26, 40, 50), ("wgrad", 55, 60, 80, 2), ("dgrad", 56, 80, 90, 2),
                 ("multi_tensor_apply_adam", 95, 100, 104), ("other", 130, 140, 141)]


def train_events(program=True):
    ev = kernels(TRAIN_KERNELS) + twins("train_step", TRAIN_KERNELS[:6])
    ev += [host("user_annotation", "train_step", 0, 110),
           host("user_annotation", "unet", 25, 52),
           host("cpu_op", "aten::conv2d", 2, 4), host("cpu_op", "aten::add", 25, 26),
           Event("cuda_runtime", "cudaMalloc", 57 * MS, 58 * MS, thread=2),
           Event("cuda_runtime", "cudaFree", 120 * MS, 121 * MS)]
    if program:
        ev += [host("cpu_op", "md.train_step", 1, 106), host("cpu_op", "md.forward", 2, 50),
               host("cpu_op", "md.encode", 2, 20), host("cpu_op", "md.backward", 50, 94),
               host("cpu_op", "md.update", 94, 105)]
    return ev


SERVE_KERNELS = [("unet_res", 2, 10, 20), ("flash", 3, 22, 26), ("k1", 4, 26, 27),
                 ("mesh", 1, 4, 8), ("decode_conv", 40, 50, 70)]


def serve_events(program=True):
    spec = sorted(SERVE_KERNELS, key=lambda k: k[2])
    ev = kernels(spec) + twins("unet", spec[1:4]) + twins("step", spec[:4])
    ev += [host("user_annotation", "call", 0, 80), host("user_annotation", "step", 0, 35),
           host("user_annotation", "unet", 1.5, 35)]
    if program:
        ev += [host("cpu_op", "md.sample", 0, 80), host("cpu_op", "md.step", 0, 35),
               host("cpu_op", "md.volume", 0.5, 1.5), host("cpu_op", "md.mesh_voxel", 0.9, 1.2),
               host("cpu_op", "md.unet", 1.5, 35), host("cpu_op", "md.unet.res", 1.6, 2.5),
               host("cpu_op", "md.unet.attn", 2.6, 3.5), host("cpu_op", "md.unet.cond", 3.6, 5),
               host("cpu_op", "md.decode", 39, 75)]
    return ev


def summary_of(prof, kind):
    s = trace.summarize(prof, 0.2, None)
    s.update(kind=kind, steps=1, calls=1, batch=1, launches={}, records=[],
             flops_per_call=1e9, peak_flops=1e15)
    return s


def readings(names, s):
    return {n: driver.load_reader(n)(s) for n in names}


def test_training_readers_on_a_hand_made_trace():
    prof = Prof(train_events())  # noqa: F841 -- the readers find it among the callers' locals
    got = readings(NEW_TRAIN, summary_of(prof, "train"))
    assert got == pytest.approx({
        "encode_ms.train": 20.0,  # vae_conv
        "backward_ms.train": 30.0,  # wgrad + dgrad, launched from thread 2
        "forward_idle_ms.train": 5.0 + 0.0,  # before elementwise (after vae_conv)
        "backward_idle_ms.train": 10.0,  # before wgrad
        "update_idle_ms.train": 10.0,  # before the AdamW kernel
        "allocator_calls_per_step.train": 1.0,  # the cudaMalloc; the cudaFree is after
    })


def test_serving_readers_on_a_hand_made_trace():
    prof = Prof(serve_events())  # noqa: F841
    got = readings(NEW_SERVE, summary_of(prof, "serve"))
    assert got == pytest.approx({"decode_ms.serve": 20.0, "conditioner_ms.serve": 4.0,
                                 "resblock_ms.serve": 10.0, "attn_ms.serve": 4.0,
                                 "depth_attn_ms.serve": 1.0})


def test_readers_read_nothing_without_the_spans():
    for events, kind, names in ((train_events(False), "train", NEW_TRAIN),
                                (serve_events(False), "serve", NEW_SERVE)):
        prof = Prof(events)
        assert set(readings(names, summary_of(prof, kind)).values()) == {None}
        del prof
    s = summary_of(Prof(train_events()), "train")  # no profiler among the callers
    assert set(readings(NEW_TRAIN, s).values()) == {None}


def _same(a, b):
    """The summaries agree on every key of `a`."""
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind,events", [("train", train_events), ("serve", serve_events)])
def test_the_port_spans_change_no_earlier_reading(kind, events):
    before = summary_of(Prof(events(False)), kind)
    prof = Prof(events(True))
    after = summary_of(prof, kind)
    _same(before, after)
    assert set(after) == set(before)
    earlier = readings(EARLIER, after)
    assert any(v is not None for v in earlier.values())
    assert earlier == readings(EARLIER, before)
    readings(NEW_TRAIN + NEW_SERVE, after)
    _same(before, after)
    assert set(after) == set(before) | {"program"}
    assert readings(EARLIER, after) == earlier


def test_within_takes_closed_ranges():
    ranges = program_spans._union([(10, 20), (15, 30), (40, 50)])
    assert [a.tolist() for a in ranges] == [[10, 40], [30, 50]]
    times = np.array([5, 10, 30, 31, 45, 60], np.int64)
    assert program_spans.within(times, ranges).tolist() == [False, True, True, False, True,
                                                           False]
