"""Idle ms per train_step before the kernels launched inside the port's
`md.update` span (zero-filled gradients, the gradient norm, AdamW)."""

from h100_bench import program_spans


def read(s):
    return program_spans.idle_ms(s, "md.update") if s["kind"] == "train" else None
