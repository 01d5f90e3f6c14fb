"""Device ms per DDIM step of the kernels launched inside the port's
`md.unet.res` spans (the UNet's ResBlocks)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.unet.res") if s["kind"] == "serve" else None
