"""Data parallelism with ``torch.distributed`` and DistributedDataParallel.

Counterpart of ``soft_truncation_tpu/parallel/mesh.py``'s 1-D ``data``
mesh. The world comes from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); without ``WORLD_SIZE`` the process trains alone and no
process group is made. ``config.tpu.mesh_shape`` may be ``()`` (every rank
on the data axis) or ``(d,)`` with d the world size; a 2-D ``(d, s)`` mesh,
JAX's spatial ``space`` axis, is not ported and raises.

Each rank runs on ``cuda:<LOCAL_RANK % cards>`` (or the CPU when asked).
The backend is NCCL where every local rank has a card of its own, else
gloo (NCCL refuses two ranks on one card; gloo reduces CUDA tensors
through the host).

The global batch (``training.batch_size``) is split so that a step on
``size`` ranks is the step of one process on the whole batch:
:func:`shard` gives rank r its rows of each micro-batch (and of each half
of it, for the mixed loss), and every random draw of the step is drawn for
the global batch from the same seeded generator on every rank, then cut to
the rank's rows (:func:`sharded_draw`, and ``models.dropout.batch_shard``
for the dropout masks). The one per-step draw of ``t_min`` is made whole on
every rank, so it agrees. DDP averages the gradients, so the optimizer, the
parameters and the EMA stay the same on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class World:
  """This process's place among the ranks; ``size`` 1 and no process group
  when the environment names none."""
  rank: int = 0
  size: int = 1
  local_rank: int = 0
  local_size: int = 1
  launched: bool = False  # the environment named a world (torchrun)

  @property
  def is_main(self) -> bool:
    return self.rank == 0


def world_from_env() -> World:
  env = os.environ
  if "WORLD_SIZE" not in env:
    return World()
  size = int(env["WORLD_SIZE"])
  return World(rank=int(env.get("RANK", 0)), size=size,
               local_rank=int(env.get("LOCAL_RANK", 0)),
               local_size=int(env.get("LOCAL_WORLD_SIZE", size)),
               launched=True)


def check_mesh(config, world: World) -> None:
  """``config.tpu.mesh_shape`` against the world: () or (world size,)."""
  mesh = tuple(config.get("tpu", {}).get("mesh_shape", ()) or ())
  if len(mesh) > 1:
    raise NotImplementedError(
        f"tpu.mesh_shape={mesh}: the 2-D (data, space) mesh of the JAX "
        "package (spatial sharding) is not ported; use (world size,) or ()")
  if mesh and mesh[0] != world.size:
    raise ValueError(f"tpu.mesh_shape={mesh} != the world size {world.size}")


@contextlib.contextmanager
def process_group(config, device="cuda"):
  """The world of this process and its device for the block, in the process
  group the environment names (joined here, and left on exit, unless the
  process is in one already). Yields ``(world, device)``."""
  world = world_from_env()
  check_mesh(config, world)
  device = resolve_device(device)
  if device.type == "cuda":
    device = torch.device("cuda", world.local_rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
  joined = world.launched and not dist.is_initialized()
  if joined:
    backend = ("nccl" if device.type == "cuda"
               and world.local_size <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=world.rank,
                            world_size=world.size)
    log.info("process group: %s, rank %d of %d on %s", backend, world.rank,
             world.size, device)
  try:
    yield world, device
  finally:
    if joined and dist.is_initialized():
      dist.destroy_process_group()


def replicate(model: torch.nn.Module, world: World) -> Optional[torch.nn.Module]:
  """The DistributedDataParallel wrapper the train step runs its forwards
  through, or None when the world is not launched."""
  if not world.launched:
    return None
  device = next(model.parameters()).device
  return torch.nn.parallel.DistributedDataParallel(
      model, device_ids=[device] if device.type == "cuda" else None)


def shard(batch: torch.Tensor, world: World, parts: int) -> torch.Tensor:
  """Rank ``world.rank``'s rows of the global ``batch``: the batch split
  into ``parts`` equal parts (micro-batches, or their halves for the
  mixed loss), and of each part its ``rank``-th of ``size`` slices."""
  if world.size == 1:
    return batch
  n = batch.shape[0]
  if n % (parts * world.size):
    raise ValueError(f"global batch {n} does not split into {parts} parts "
                     f"on {world.size} ranks")
  rows = n // (parts * world.size)
  chunks = batch.reshape((parts, world.size, rows) + batch.shape[1:])
  return chunks[:, world.rank].reshape((parts * rows,) + batch.shape[1:])


def sharded_draw(draw: Callable, rank: int, size: int) -> Callable:
  """``draw`` for the global batch cut to this rank's rows: a draw whose
  leading dimension is a rank's n rows is made for n * size rows and its
  rows [rank * n, (rank + 1) * n) kept; a 0-d draw (``t_min``) is made
  whole."""

  def draw_rows(kind, shape, high=None):
    shape = tuple(shape)
    if not shape:
      return draw(kind, shape, high)
    n = shape[0]
    return draw(kind, (n * size,) + shape[1:], high)[rank * n:(rank + 1) * n]

  return draw_rows


def gather(t: torch.Tensor) -> torch.Tensor:
  """Every rank's ``t`` concatenated (rank order); ``t`` alone without a
  process group."""
  if not dist.is_initialized() or dist.get_world_size() == 1:
    return t
  parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
  dist.all_gather(parts, t.contiguous())
  return torch.cat(parts)
