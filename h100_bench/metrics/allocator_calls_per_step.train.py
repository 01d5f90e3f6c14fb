"""The caching allocator's calls to cudaMalloc and cudaFree per
train_step: the CUDA runtime's records of them inside the port's
`md.train_step` span (what `spans.counters()` counts)."""

from h100_bench import program_spans


def read(s):
    return program_spans.allocator_calls(s, "md.train_step") if s["kind"] == "train" else None
