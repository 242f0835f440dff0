"""Dropout of the res-blocks.

Counterpart of ``soft_truncation_tpu/models/dropout.py``. At ``bits=32``
the semantics of ``flax.linen.Dropout``: at train, a Bernoulli keep-mask
with keep = 1 - rate, then ``x / keep`` where kept and 0 elsewhere; the
identity at eval or at rate 0, zeros at rate 1. At ``bits`` 8 or 16 (the
NCSN++ res-blocks' default, ``configs/base.py::dropout_bits``), where the
channels split into lanes of that width, JAX's packed masks: one uniform
uint32 word per 32 / bits channels, unpacked into lanes (little-endian,
as JAX's bitcast), the mask ``lanes < round(keep * 2^bits)`` and the kept
values scaled by the quantized keep rate q = round(keep * 2^bits) /
2^bits (at rate 0.1 and 8 bits: 230 / 256); the identity where q rounds
to 1. The uniforms and words come from the ``torch.Generator`` the caller
passes down (one per train step), so the mask does not match JAX's bits:
tests hand both packages the same mask through :func:`keep_mask` or the
same words through :func:`draw_lanes`. Under data parallelism
(``parallel/ddp.py``) :func:`batch_shard` makes each draw the global
batch's, cut to this rank's rows (and, under a space axis, to its image
rows).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from ..parallel.ddp import sharded_draw


_SHARD = (0, 1, 0, 1)  # (rank, ranks, space rank, space ranks) of a mask
PACKED_BITS = (8, 16)  # the lane widths of a packed mask


@contextlib.contextmanager
def batch_shard(rank: int, size: int, space_rank: int = 0,
                space_size: int = 1):
  """Within the block, a mask of n rows is drawn for n * ``size`` rows and
  its rows [rank * n, (rank + 1) * n) kept: the global batch's mask; under
  a space axis of ``space_size`` ranks a mask of image shape [n, L, W, C]
  is drawn for L * ``space_size`` image rows, of which this rank keeps
  [space_rank * L, (space_rank + 1) * L)."""
  global _SHARD
  old, _SHARD = _SHARD, (rank, size, space_rank, space_size)
  try:
    yield
  finally:
    _SHARD = old


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
  """Bernoulli(keep) mask of ``shape``: uniform < keep (see
  :func:`batch_shard`)."""

  def uniform(kind, shape, high=None):
    return torch.rand(shape, generator=generator, device=device)

  return sharded_draw(uniform, *_SHARD)("uniform", tuple(shape)) < keep


def draw_lanes(shape, bits: int, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
  """Uniform ``bits``-wide lanes of ``shape`` (int64 in [0, 2^bits)): one
  uint32 word per 32 / bits channels of the last axis, drawn as
  [..., C * bits / 32] (see :func:`batch_shard`) and unpacked low bits
  first, as JAX's ``bitcast_convert_type`` of its ``random.bits`` words."""
  shape = tuple(shape)
  pack = 32 // bits

  def words(kind, shape, high=None):
    return torch.randint(0, 1 << 32, shape, generator=generator,
                         device=device, dtype=torch.int64)

  w = sharded_draw(words, *_SHARD)("bits", shape[:-1]
                                   + (shape[-1] // pack,))
  shifts = torch.arange(pack, device=w.device) * bits
  return ((w[..., None] >> shifts) & ((1 << bits) - 1)).reshape(shape)


class Dropout(nn.Module):

  def __init__(self, rate: float, bits: int = 32):
    super().__init__()
    self.rate = rate
    self.bits = bits

  def forward(self, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not train or self.rate == 0.0:
      return x
    if self.rate == 1.0:
      return torch.zeros_like(x)
    keep = 1.0 - self.rate
    if self.bits in PACKED_BITS and x.shape[-1] % (32 // self.bits) == 0:
      span = 1 << self.bits
      thresh = int(round(keep * span))
      if thresh >= span:  # a rate below half a step of 1 / 2^bits
        return x
      mask = draw_lanes(x.shape, self.bits, generator, x.device) < thresh
      return torch.where(mask, x / (thresh / span), torch.zeros_like(x))
    mask = keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
