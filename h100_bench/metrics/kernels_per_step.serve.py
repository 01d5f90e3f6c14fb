"""Device kernels (copies and sets included) per DDIM step, counted in the
trace: the host's load."""

from h100_bench import trace


def read(s):
    if s["kind"] != "serve" or not s["steps"]:
        return None
    m = trace.step_regions(s)
    return float(m.sum()) / s["steps"] if m.any() else None
