"""Device ms per DDIM step under the UNet span."""

from h100_bench import trace


def read(s):
    return trace.ms_per_step(s, trace.inside(s, "unet")) if s["kind"] == "serve" else None
