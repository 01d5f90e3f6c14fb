"""Samplers of the PyTorch port."""

from morphablediffusion_torch.sampling.ddim import SyncDDIMSampler

__all__ = ["SyncDDIMSampler"]
