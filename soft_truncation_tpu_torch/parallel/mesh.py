"""The 2-D ``(data, space)`` mesh of ranks.

Counterpart of ``soft_truncation_tpu/parallel/mesh.py``. There a mesh
``(d, s)`` of devices names its axes ``data`` and ``space``;
``batch_sharding(mesh, spatial=True)`` shards the batch over ``data`` and
the image height over ``space``, and GSPMD inserts the halo exchanges,
cross-shard reductions and gathers. Here the mesh is laid over the ranks
``torchrun`` launches (``ddp.world_from_env``): rank r is at ``(r // s,
r % s)``, so the ranks of one space group are consecutive. Each space
group is a ``torch.distributed`` group, made once with ``dist.new_group``;
what is reduced over ``data`` is reduced over the whole world. The
collectives the layers run over ``space`` are in ``spatial.py``.

``config.tpu.mesh_shape`` ``()`` or ``(world size,)`` is the 1-D data mesh
of ``ddp.py`` (a space of one rank): nothing here changes it.

:func:`shard_batch` gives this rank's rows of the global batch and, with
``spatial``, its H/s image rows. It is also the counterpart of JAX's
``stacked_batch_sharding`` / ``shard_stacked_batch`` (this rank's rows of
every step of a ``[K, B, ...]`` window): ``train/step.py::
make_multi_train_step`` cuts each step of a window with it, after that
step's preprocess, since the port draws the dequantization noise of the
global batch from its one generator in step order (JAX draws it from
per-step keys, so it can place the whole stack first); on every route of
the window (``train/step.py::window_route``). :func:`batch_sharded` /
:func:`batch_mean` let a sampler whose batch is split over the ranks take
the means it steers by (dopri5's error norm, the Langevin step size) over
the whole batch (``serve/server.py``'s replay on several ranks).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .ddp import World, gather, shard
from .spatial import Space

DATA_AXIS = "data"
SPACE_AXIS = "space"


def mesh_dims(mesh_shape: Sequence[int], world: World) -> Tuple[int, int]:
  """``(d, s)`` of ``mesh_shape``: ``()`` is ``(world size, 1)``, ``(d,)``
  is ``(d, 1)``. Raises where d * s is not the world size."""
  shape = tuple(int(v) for v in (mesh_shape or ()))
  if len(shape) > 2:
    raise NotImplementedError(
        f"tpu.mesh_shape={shape}: axes past (data, space) are not ported")
  d, s = (shape + (1,))[:2] if shape else (world.size, 1)
  if d * s != world.size:
    raise ValueError(f"tpu.mesh_shape={shape} ({d} x {s} ranks) != the "
                     f"world size {world.size}")
  return d, s


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This rank's place on the ``(data, space)`` mesh and the process group
  of its space axis (None where the axis has one rank or no process group
  is made). Over ``data`` the ranks reduce over the whole world (gradients,
  ``train/step.py``; losses, :func:`first_of_space`), so that axis needs
  no group of its own."""
  data: int = 1
  space: int = 1
  data_index: int = 0
  space_index: int = 0
  space_group: Optional[object] = None

  @property
  def size(self) -> int:
    return self.data * self.space

  def space_shard(self) -> Optional[Space]:
    """The space the layers shard over (``spatial.sharded``), or None."""
    if self.space == 1:
      return None
    return Space(self.space_group, self.space_index, self.space)


def make_mesh(mesh_shape: Sequence[int], world: World) -> Mesh:
  """The mesh ``mesh_shape`` over ``world``: this rank's (data index,
  space index) and, with a space axis in a launched world, its space
  group (every rank makes every group, in the same order, as
  ``dist.new_group`` asks)."""
  d, s = mesh_dims(mesh_shape, world)
  data_index, space_index = divmod(world.rank, s)
  space_group = None
  if s > 1 and world.launched:
    for j in range(d):
      group = dist.new_group([j * s + i for i in range(s)])
      if j == data_index:
        space_group = group
  return Mesh(d, s, data_index, space_index, space_group)


def shard_batch(batch: torch.Tensor, mesh: Mesh, spatial: bool = False,
                parts: int = 1) -> torch.Tensor:
  """This rank's rows of the global NHWC ``batch``: of each of ``parts``
  equal parts (micro-batches, or their halves) its data index's slice
  (``ddp.shard``) and, with ``spatial``, its space index's H/s rows."""
  rows = shard(batch, World(rank=mesh.data_index, size=mesh.data,
                            launched=mesh.data > 1), parts)
  if not spatial or mesh.space == 1:
    return rows
  if batch.shape[1] % mesh.space:
    raise ValueError(f"image height {batch.shape[1]} does not split over "
                     f"{mesh.space} space ranks")
  return Space(None, mesh.space_index, mesh.space).rows(rows)


def first_of_space(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """Of a tensor gathered over the world (rank order), the rows of the
  ranks at space index 0: each data group's values once."""
  if mesh.space == 1:
    return t
  return t.reshape((mesh.data, mesh.space, -1) + tuple(t.shape[1:]))[
      :, 0].reshape((-1,) + tuple(t.shape[1:]))


_BATCH_SHARDED = False  # while a sampler's batch is split over the world


@contextlib.contextmanager
def batch_sharded():
  """Within the block :func:`batch_mean` takes its mean over every rank of
  the world, whose shards make up the batch."""
  global _BATCH_SHARDED
  old, _BATCH_SHARDED = _BATCH_SHARDED, True
  try:
    yield
  finally:
    _BATCH_SHARDED = old


def batch_mean(v: torch.Tensor) -> torch.Tensor:
  """The mean of every element of ``v``; within :func:`batch_sharded`, of
  every rank's ``v`` (``v`` being this rank's rows of a batch tensor):
  the same mean of the same elements in the same order as one process
  takes, so the ranks steer as one process does, bit for bit."""
  if not _BATCH_SHARDED:
    return torch.mean(v)
  return torch.mean(gather(v.reshape(-1)))


def check_space(config, s: int) -> None:
  """What a space axis of ``s`` ranks asks of ``config``: the NCSN++
  family without fp8, every level's height divisible by s and a shard at
  the coarsest level at least as tall as the widest halo."""
  model = config.model
  if model.name != "ncsnpp":
    raise NotImplementedError(
        f"model {model.name!r} under a space axis: only the NCSN++ family "
        "is sharded over image rows (ROADMAP.md, slice 6e)")
  if config.get("tpu", {}).get("activation_dtype"):
    raise NotImplementedError(
        "tpu.activation_dtype (fp8 convs) under a space axis is not ported "
        "(ROADMAP.md, slice 6e)")
  # the most rows a layer reads from a neighbour: 2 with FIR (a
  # downsample's halo is even, for the stride-2 phase), else 1 (a 3x3 conv)
  halo = 2 if model.fir else 1
  for i in range(len(model.ch_mult)):
    res = config.data.image_size // 2 ** i
    if res % s:
      raise ValueError(f"level {i} ({res}x{res}) does not split into {s} "
                       "shards of rows")
    if res // s < halo:
      raise ValueError(
          f"level {i} ({res}x{res}): a shard of {res // s} rows is thinner "
          f"than the widest halo ({halo} rows); use at most "
          f"{max(1, res // halo)} space ranks")


def local_shape(config, mesh: Mesh, batch: int) -> Tuple[int, ...]:
  """The NHWC shape of this rank's part of a global ``batch``."""
  size = config.data.image_size
  return (batch // mesh.data, size // mesh.space, size,
          config.data.num_channels)

