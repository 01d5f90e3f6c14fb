"""Idle ms per train_step before the kernels launched inside the port's
`md.backward` span, from any thread."""

from h100_bench import program_spans


def read(s):
    return program_spans.idle_ms(s, "md.backward") if s["kind"] == "train" else None
