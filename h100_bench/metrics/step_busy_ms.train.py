"""Device time with at least one kernel running, per train_step."""

from h100_bench import trace


def read(s):
    if s["kind"] != "train" or not s["steps"]:
        return None
    m = trace.step_regions(s)
    return trace.union_s(s["start"][m], s["end"][m]) * 1e3 / s["steps"] if m.any() else None
