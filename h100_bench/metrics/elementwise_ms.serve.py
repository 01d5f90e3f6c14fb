"""Device ms per DDIM step of the elementwise, copy, cast and layout kernels
(the group `elementwise and other`)."""

import numpy as np

from h100_bench import trace


def read(s):
    if s["kind"] != "serve":
        return None
    group = np.array([g == "elementwise and other" for g in s["group"]], bool)
    return trace.ms_per_step(s, trace.step_regions(s) & group)
