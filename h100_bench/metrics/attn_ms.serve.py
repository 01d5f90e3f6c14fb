"""Device ms per DDIM step of the kernels launched inside the port's
`md.unet.attn` spans (the UNet's SpatialTransformers, K2)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.unet.attn") if s["kind"] == "serve" else None
