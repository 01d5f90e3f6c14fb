"""The ranks a run spans, one process each.

Counterpart of the JAX package's `parallel/mesh.py`. There a 1-D
`jax.sharding.Mesh` over the "data" axis shards the training batch, and one
over the "view" axis shards the sampler's views; XLA inserts the collectives.
Here each rank is a process (started by `python -m torch.distributed.run`,
or by `torch.multiprocessing` in the tests) with its own device, and the
code calls the collectives itself (`parallel/collectives.py`):

  * `create_mesh()` reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/MASTER_PORT) and initialises the process group
    with an explicit backend and timeout. Without that environment it
    returns a world of one rank and creates no group: the JAX "one device"
    case, not a fallback;
  * rank r runs on cuda:{LOCAL_RANK % device_count} (or on the CPU when the
    caller asks for it). Under NCCL two ranks on one card fail with NCCL's
    own error; under gloo they share the card;
  * `shard_batch(batch, mesh)` is this rank's rows of a global batch (the
    "data" axis), `view_range(mesh, N)` its contiguous views (the "view"
    axis).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from morphablediffusion_torch.utils import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """rank of world, its device, and the process group (None for a world
    of one rank without a group) with its backend."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device of a rank: the CPU when asked for, else the card
    local_rank % device_count (raises without a card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def create_mesh(backend: Optional[str] = None, device=None,
                timeout: datetime.timedelta = DEFAULT_TIMEOUT, *, rank: Optional[int] = None,
                world: Optional[int] = None, init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process.

    rank and world default to torchrun's RANK and WORLD_SIZE (init_method
    then 'env://'); given explicitly (tests, a one-rank group), init_method
    is required. Neither given: a world of one rank on `device` (see
    `utils.resolve_device`) and no group. backend defaults to 'nccl' on the
    card and 'gloo' on the CPU."""
    env = os.environ
    if rank is None and "RANK" not in env:
        return Mesh(device=resolve_device(device))
    if rank is None:
        rank, world, init_method = int(env["RANK"]), int(env["WORLD_SIZE"]), "env://"
        local_rank = int(env.get("LOCAL_RANK", rank))
    elif init_method is None or world is None:
        raise ValueError("create_mesh: an explicit rank needs world and init_method")
    else:
        local_rank = rank
    dev = rank_device(local_rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("create_mesh: the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    print(f"rank {rank} of {world}: {dev} ({backend})", flush=True)
    return Mesh(rank, world, dev, dist.group.WORLD, backend)


def close_mesh(mesh: Mesh) -> None:
    """Destroy the mesh's process group, if it has one."""
    if mesh.group is not None:
        dist.destroy_process_group(mesh.group)


def shard_rows(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of n: equal contiguous shards in rank
    order. Raises unless the world divides n."""
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's rows of every leaf of a global batch (leading axis)."""
    out = {}
    for k, v in batch.items():
        lo, hi = shard_rows(v.shape[0], mesh)
        out[k] = v[lo:hi]
    return out


def view_range(mesh: Optional[Mesh], n_views: int) -> Tuple[int, int]:
    """This rank's contiguous views [r N / W, (r + 1) N / W). Raises unless
    the world divides the view count (as the JAX CLI asserts)."""
    try:
        return shard_rows(n_views, mesh)
    except ValueError:
        raise ValueError(f"view_num {n_views} must divide over {mesh.world} ranks") from None
