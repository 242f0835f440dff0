"""Data parallelism of the PyTorch port (``ddp.py``)."""

from .ddp import (World, check_mesh, process_group, replicate, shard,
                  sharded_draw, world_from_env)

__all__ = ["World", "check_mesh", "process_group", "replicate", "shard",
           "sharded_draw", "world_from_env"]
