"""Idle ms per train_step before the kernels launched inside the port's
`md.forward` span (the loss forward, the frozen encoders included)."""

from h100_bench import program_spans


def read(s):
    return program_spans.idle_ms(s, "md.forward") if s["kind"] == "train" else None
