"""Device ms per train_step of the kernels launched inside the port's
`md.encode` span (the frozen VAE encoder of targets and input, and CLIP)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.encode") if s["kind"] == "train" else None
