"""Data and spatial parallelism of the PyTorch port: the ranks' world and
DDP (``ddp.py``), the 2-D ``(data, space)`` mesh (``mesh.py``) and the
collectives of a sharded image (``spatial.py``)."""

from .ddp import (World, check_mesh, join, process_group, replicate, shard,
                  sharded_draw, world_from_env)
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh, make_mesh, shard_batch

__all__ = ["DATA_AXIS", "SPACE_AXIS", "Mesh", "World", "check_mesh", "join",
           "make_mesh", "process_group", "replicate", "shard", "shard_batch",
           "sharded_draw", "world_from_env"]
