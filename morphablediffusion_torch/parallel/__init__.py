"""Running the port on more than one rank: `mesh` (the ranks, their devices
and process group) and `collectives` (the three collectives the port uses)."""

from morphablediffusion_torch.parallel.mesh import (Mesh, close_mesh, create_mesh,
                                                    shard_batch, view_range)

__all__ = ["Mesh", "close_mesh", "create_mesh", "shard_batch", "view_range"]
