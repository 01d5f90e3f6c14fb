"""Share of the traced window (whole calls, host clock) in which no kernel
ran on the device, in %."""


def read(s):
    if s["kind"] != "serve" or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
