"""Config and device helpers of the PyTorch port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the CUDA card: without one this raises instead of carrying on
    quietly on the CPU, as a CUDA device asked for by name does. The CPU is
    used only when the caller asks for it (``device="cpu"``), as the tests do.
    """
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device(device or "cuda")
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('bfloat16' | 'float32') -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
