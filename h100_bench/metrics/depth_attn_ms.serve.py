"""Device ms per DDIM step of the kernels launched inside the port's
`md.unet.cond` spans (the UNet's DepthTransformers, K1 and K3)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.unet.cond") if s["kind"] == "serve" else None
