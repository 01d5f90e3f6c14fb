"""The model's FLOPs for the traced window's work (counts.py, from shapes,
whatever kernels run) over the window's seconds and one card's bf16 peak,
in %."""


def read(s):
    if s["kind"] != "train" or s["busy_s"] <= 0:
        return None
    return 100.0 * s["flops_per_call"] * s["calls"] / s["window_s"] / s["peak_flops"]
