"""A learned monotone log-SNR schedule, in PyTorch.

Counterpart of ``soft_truncation_tpu/models/logsnr.py``: vestigial there
(no config or path uses it), ported so that the port holds what the JAX
package holds. ``PosDense`` keeps its weights positive through a softplus,
so ``LogSNR``'s gamma(t) is monotone in t; it is normalized to the learned
endpoints ``[gamma_min, gamma_min + softplus(gamma_gap)]`` over [0, 1].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class PosDense(nn.Module):
  """A dense layer with softplus-positive weights; ``weight`` [out, in]
  (Flax's ``kernel`` transposed), LeCun-normal init, zero bias."""

  def __init__(self, in_features: int, out_features: int):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features))

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    std = math.sqrt(1.0 / self.weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
      nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                            generator=generator)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return x @ F.softplus(self.weight).T + self.bias


class LogSNR(nn.Module):
  """gamma(t) of a [B] (or any shape) tensor of times, as [B]."""

  def __init__(self, mid_dim: int = 1024, gamma_min_init: float = -10.0,
               gamma_gap_init: float = 20.0):
    super().__init__()
    self.inits = (gamma_min_init, gamma_gap_init)
    self.gamma_min = nn.Parameter(torch.tensor(gamma_min_init))
    self.gamma_gap = nn.Parameter(torch.tensor(gamma_gap_init))
    self.l1 = PosDense(1, 1)
    self.l2 = PosDense(1, mid_dim)
    self.l3 = PosDense(mid_dim, 1)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self.gamma_min.fill_(self.inits[0])
      self.gamma_gap.fill_(self.inits[1])
    for m in (self.l1, self.l2, self.l3):
      m.reset_parameters(generator)

  def _body(self, u: torch.Tensor) -> torch.Tensor:
    h = self.l1(u)
    return h + self.l3(torch.sigmoid(self.l2(h)))

  def forward(self, t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1, 1)
    g_t = self._body(t)
    g_0 = self._body(torch.zeros_like(t))
    g_1 = self._body(torch.ones_like(t))
    norm = (g_t - g_0) / (g_1 - g_0)
    return (self.gamma_min + F.softplus(self.gamma_gap) * norm).reshape(-1)
