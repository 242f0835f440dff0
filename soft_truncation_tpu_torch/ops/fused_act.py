"""Fused bias + leaky ReLU with a gain, in PyTorch.

Counterpart of ``soft_truncation_tpu/ops/fused_act.py`` (the reference's
StyleGAN2 ``fused_bias_act``): the bias broadcast over the channel (last)
axis, then the activation, then the gain. The JAX package computes it as
one jitted XLA elementwise fusion, outside any Pallas call, so the port
computes it with plain tensor ops; no path of either package calls it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   act: str = "lrelu", negative_slope: float = 0.2,
                   scale: float = math.sqrt(2.0)) -> torch.Tensor:
  """bias-add, then 'linear' (no activation, no gain) or 'lrelu' (leaky
  ReLU times ``scale``)."""
  if bias is not None:
    x = x + bias.reshape((1,) * (x.dim() - 1) + (-1,))
  if act == "linear":
    return x
  if act == "lrelu":
    return torch.where(x >= 0, x, x * negative_slope) * scale
  raise ValueError(f"unknown act {act!r}")


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = 2.0 ** 0.5) -> torch.Tensor:
  return fused_bias_act(x, bias, act="lrelu", negative_slope=negative_slope,
                        scale=scale)


class FusedLeakyReLU(nn.Module):
  """:func:`fused_leaky_relu` with a learnable ``bias`` (zero at init)."""

  def __init__(self, channels: int, negative_slope: float = 0.2,
               scale: float = 2.0 ** 0.5):
    super().__init__()
    self.negative_slope, self.scale = negative_slope, scale
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
