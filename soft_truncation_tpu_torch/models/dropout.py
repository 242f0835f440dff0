"""Dropout of the res-blocks.

Counterpart of ``soft_truncation_tpu/models/dropout.py`` at ``bits=32``,
the semantics of ``flax.linen.Dropout``: at train, a Bernoulli keep-mask
with keep = 1 - rate, then ``x / keep`` where kept and 0 elsewhere; the
identity at eval or at rate 0, zeros at rate 1. The uniforms come from the
``torch.Generator`` the caller passes down (one per train step), so the
mask does not match JAX's bits: tests hand both packages the same mask
through :func:`keep_mask`. The JAX package's ``config.tpu.dropout_bits``
(8/16-bit packed masks, a TPU hashing knob) has no meaning here and is not
read. Under data parallelism (``parallel/ddp.py``) :func:`batch_shard`
makes each mask the global batch's, cut to this rank's rows.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn


_SHARD = (0, 1)  # (rank, ranks) of the batch rows a mask is drawn for


@contextlib.contextmanager
def batch_shard(rank: int, size: int):
  """Within the block, a mask of n rows is drawn for n * ``size`` rows and
  its rows [rank * n, (rank + 1) * n) kept: the global batch's mask."""
  global _SHARD
  old, _SHARD = _SHARD, (rank, size)
  try:
    yield
  finally:
    _SHARD = old


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
  """Bernoulli(keep) mask of ``shape``: uniform < keep (see
  :func:`batch_shard`)."""
  rank, size = _SHARD
  if size == 1:
    return torch.rand(shape, generator=generator, device=device) < keep
  n = shape[0]
  u = torch.rand((n * size,) + tuple(shape[1:]), generator=generator,
                 device=device)
  return u[rank * n:(rank + 1) * n] < keep


class Dropout(nn.Module):

  def __init__(self, rate: float):
    super().__init__()
    self.rate = rate

  def forward(self, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not train or self.rate == 0.0:
      return x
    if self.rate == 1.0:
      return torch.zeros_like(x)
    keep = 1.0 - self.rate
    mask = keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
