"""Several devices over `torch.distributed`: data groups and their
collectives (`mesh`), plane-spatial sharding with halo exchange
(`halo`)."""

from . import halo, mesh
from .halo import gather_plane, halo_conv2d, shard_plane
from .mesh import (DataGroup, all_reduce, all_reduce_many, gather_rows,
                   maybe_initialize_distributed, shard_range, spawn)
