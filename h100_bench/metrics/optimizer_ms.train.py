"""Device ms per train_step under the profiler's own AdamW annotation."""

from h100_bench import trace


def read(s):
    if s["kind"] != "train":
        return None
    return trace.ms_per_step(s, trace.inside(s, "Optimizer.step#AdamW.step"))
