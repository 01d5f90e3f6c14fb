"""Device ms per DDIM step under the spatial-volume spans: the target
encoder, unprojection, mesh conditioner and frustum volumes."""

from h100_bench import trace


def read(s):
    return trace.ms_per_step(s, trace.inside(s, "volume")) if s["kind"] == "serve" else None
