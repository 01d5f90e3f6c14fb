"""Device ms per train_step of the kernels launched inside the port's
`md.backward` span (the backward, recomputed blocks included), from any
thread."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.backward") if s["kind"] == "train" else None
