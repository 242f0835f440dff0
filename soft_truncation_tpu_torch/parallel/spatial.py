"""The collectives of a sharded image: each rank of a ``space`` group holds
H/s rows of every image.

In the JAX package GSPMD inserts these when an activation is sharded over
the mesh's ``space`` axis (``parallel/mesh.py::batch_sharding(spatial=
True)``). Here they are written out, each a ``torch.autograd.Function``
whose backward is its forward's exact adjoint over the group:

- :meth:`Space.halo`: the neighbours' edge rows above and below this
  rank's (zeros past the image's top and bottom, which is a conv's SAME
  padding); the backward adds the halo's gradient into the neighbours'
  edge rows;
- :meth:`Space.sum`: a sum over the group (all-reduce), whose backward is
  the same sum of the gradients;
- :meth:`Space.gather`: every rank's rows, in order; the backward is this
  rank's rows of the summed gradient.

With exact adjoints, a backward run on every rank from the same replicated
loss gives each rank its share of the gradient of the sum of the s copies
of that loss: the parameters' gradients summed over the group are s times
the loss's, so the mean over the whole world (data x space) is the step of
one process on the whole batch (``train/step.py``).

The collectives are built from ``all_gather`` and ``all_reduce`` alone,
which gloo takes for CUDA tensors too (ranks sharing one card run gloo,
``parallel/ddp.py::process_group``); gloo takes no CUDA tensor for
point-to-point ``send`` / ``recv``.

The layers read the current space from :func:`current`, set for a block by
:func:`sharded` (``train/step.py`` sets it for the step's forwards and
losses); ``None`` (no space axis, or s = 1) leaves every layer as it is
and launches no collective. :data:`calls` counts the collectives by
Function and direction ('halo', 'halo_backward', 'sum', ...), and those
the train step issues itself ('gradients': its one all-reduce of the
flattened gradients; 'ratio': the balanced mixed loss's), when Python
issues them: a CUDA graph's replay counts nothing, so a captured window
records its own per capture (``train/step.py::make_multi_train_step``'s
``capture_collectives``), to be taken times its replays.
"""

from __future__ import annotations

import collections
import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist


calls = collections.Counter()  # collectives launched, by kind


class Space:
  """This rank's place on the ``space`` axis: its ``index`` of ``size``
  ranks in ``group`` (a ``torch.distributed`` process group)."""

  def __init__(self, group, index: int, size: int):
    self.group, self.index, self.size = group, index, size

  def halo(self, x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """NHWC ``x`` (this rank's L rows) with ``above`` rows of the rank
    above and ``below`` rows of the rank below around it: [N, above + L +
    below, W, C]."""
    if max(above, below) > x.shape[1]:
      raise ValueError(
          f"a shard of {x.shape[1]} rows cannot give a halo of "
          f"{max(above, below)} rows: fewer ranks on the space axis")
    if above == below == 0:
      return x
    return self._halo(x, above, below)

  def _halo(self, x, above, below):
    return _Halo.apply(x, above, below, self)

  def sum(self, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group, on every rank."""
    return _Sum.apply(t, self)

  def gather(self, x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` of every rank of the group, concatenated along H."""
    return _Gather.apply(x, self)

  def rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's rows of ``t`` (the whole image's along ``dim``)."""
    n = t.shape[dim] // self.size
    return t.narrow(dim, self.index * n, n)

  def _all_gather(self, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
    calls[kind] += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(self.size)]
    dist.all_gather(parts, t, group=self.group)
    return parts

  def _all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
    calls[kind] += 1
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=self.group)
    return t


class _Halo(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, above: int, below: int, space: Space):
    ctx.args = (above, below, space)
    n, rows = x.shape[:2]
    # the rank above reads my first `below` rows, the rank below my last
    # `above` rows
    parts = space._all_gather(torch.cat(
        [x[:, :below], x[:, rows - above:]], 1), "halo")
    i = space.index
    top = (parts[i - 1][:, below:] if i > 0 else
           x.new_zeros((n, above) + tuple(x.shape[2:])))
    bottom = (parts[i + 1][:, :below] if i < space.size - 1 else
              x.new_zeros((n, below) + tuple(x.shape[2:])))
    return torch.cat([top, x, bottom], 1)

  @staticmethod
  def backward(ctx, g):
    above, below, space = ctx.args
    rows = g.shape[1] - above - below
    parts = space._all_gather(torch.cat([g[:, :above], g[:, above + rows:]],
                                        1), "halo_backward")
    gx = g[:, above:above + rows].clone()
    i = space.index
    if i < space.size - 1 and above:  # the rank below's halo of my rows
      gx[:, rows - above:] += parts[i + 1][:, :above]
    if i > 0 and below:  # the rank above's
      gx[:, :below] += parts[i - 1][:, above:]
    return gx, None, None, None


class _Sum(torch.autograd.Function):

  @staticmethod
  def forward(ctx, t, space: Space):
    ctx.space = space
    return space._all_reduce(t, "sum")

  @staticmethod
  def backward(ctx, g):
    return ctx.space._all_reduce(g, "sum_backward"), None


class _Gather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, space: Space):
    ctx.space = space
    return torch.cat(space._all_gather(x, "gather"), 1)

  @staticmethod
  def backward(ctx, g):
    space = ctx.space
    return space.rows(space._all_reduce(g, "gather_backward")), None


_CURRENT: Optional[Space] = None


def current() -> Optional[Space]:
  """The space the layers shard over, or None."""
  return _CURRENT


@contextlib.contextmanager
def sharded(space: Optional[Space]):
  """Within the block the layers hold ``space``'s rows of each image (None,
  or a space of one rank: the whole image)."""
  global _CURRENT
  old = _CURRENT
  _CURRENT = space if space is not None and space.size > 1 else None
  try:
    yield
  finally:
    _CURRENT = old


def refuse(what: str) -> None:
  """Raise for ``what`` (a layer or path) under a space axis."""
  if _CURRENT is not None:
    raise NotImplementedError(
        f"{what} is not sharded over the space axis; no JAX path runs it "
        "so (ROADMAP.md, slice 6e)")
