"""Device ms per sampler call of the kernels launched inside the port's
`md.decode` span (the VAE decode of the avatars)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.decode", "calls") if s["kind"] == "serve" else None
