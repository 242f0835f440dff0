"""Dropout of the res-blocks.

Counterpart of ``soft_truncation_tpu/models/dropout.py`` at ``bits=32``,
the semantics of ``flax.linen.Dropout``: at train, a Bernoulli keep-mask
with keep = 1 - rate, then ``x / keep`` where kept and 0 elsewhere; the
identity at eval or at rate 0, zeros at rate 1. The uniforms come from the
``torch.Generator`` the caller passes down (one per train step), so the
mask does not match JAX's bits: tests hand both packages the same mask
through :func:`keep_mask`. The JAX package's ``config.tpu.dropout_bits``
(8/16-bit packed masks, a TPU hashing knob) has no meaning here and is not
read.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
  """Bernoulli(keep) mask of ``shape``: uniform < keep."""
  return torch.rand(shape, generator=generator, device=device) < keep


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
