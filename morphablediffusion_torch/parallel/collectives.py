"""The three collectives of the port. Nothing else in the port calls
`torch.distributed`.

  * `all_reduce_sum(x, mesh)`: the fp32 sum over ranks;
  * `all_gather_cat(x, dim, mesh)`: every rank's x concatenated along dim,
    in rank order;
  * `reduce_scatter_flat(flat, mesh)`: the sum over ranks of a flat buffer,
    this rank's equal shard of it.

Under NCCL they call the native collectives on the card's tensors. Under
gloo a CUDA tensor is staged explicitly through a host buffer and back (the
ranks that share one card in the tests of the card): gloo's CUDA support
covers fewer collectives than NCCL's, and what it covers differs between
torch versions, so staging makes that run behave the same everywhere. On a
mesh without a group each is the identity of one rank.

`STATS` counts the calls, the bytes each rank sends in, and the host
seconds spent inside them (for gloo that includes the staging copies; for
NCCL it is the enqueue, the device time is not in it).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from morphablediffusion_torch.parallel.mesh import Mesh

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


def _run(fn, x: torch.Tensor, mesh: Mesh, out_shape) -> torch.Tensor:
    """fn(out, inp) on host copies under gloo when x is on the card, on x's
    device otherwise; returns out on x's device."""
    t0 = time.perf_counter()
    staged = mesh.backend == "gloo" and x.is_cuda
    inp = x.cpu() if staged else x
    out = torch.empty(out_shape, dtype=x.dtype, device=inp.device)
    with warnings.catch_warnings():  # torch 2.13 renames the *_tensor collectives
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, inp)
    if staged:
        out = out.to(x.device)
    STATS["calls"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    STATS["seconds"] += time.perf_counter() - t0
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the ranks, in fp32 (a new tensor)."""
    x = x.detach().to(torch.float32)
    if mesh is None or mesh.group is None:
        return x.clone()

    def fn(out, inp):
        out.copy_(inp)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)

    return _run(fn, x.contiguous(), mesh, x.shape)


def all_gather_cat(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's x (same shape on each) concatenated along dim in rank
    order."""
    if mesh is None or mesh.group is None:
        return x
    y = x.detach().movedim(dim, 0).contiguous()
    out = _run(lambda o, i: dist.all_gather_into_tensor(o, i, group=mesh.group), y, mesh,
               (mesh.world * y.shape[0],) + y.shape[1:])
    return out.movedim(0, dim).contiguous()


def reduce_scatter_flat(flat: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of the sum over ranks of the 1-D fp32 buffer flat,
    whose length the world divides: elements [r n / W, (r + 1) n / W)."""
    if flat.ndim != 1 or flat.dtype != torch.float32:
        raise ValueError("reduce_scatter_flat: takes a 1-D fp32 buffer")
    if mesh is None or mesh.group is None:
        return flat
    if flat.numel() % mesh.world:
        raise ValueError(f"reduce_scatter_flat: {flat.numel()} elements do not split over "
                         f"{mesh.world} ranks")
    return _run(lambda o, i: dist.reduce_scatter_tensor(o, i, op=dist.ReduceOp.SUM,
                                                        group=mesh.group),
                flat.contiguous(), mesh, (flat.numel() // mesh.world,))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank gets here (a one-element all_reduce_sum)."""
    if mesh is not None and mesh.group is not None:
        all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)
