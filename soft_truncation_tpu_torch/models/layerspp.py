"""NCSN++ building blocks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/layerspp.py``: the blocks the
flagship DDPM++ runs (``AttnBlockpp``, ``ResnetBlockBigGANpp`` without FIR)
and the Gaussian Fourier time embedding.

At eval with SiLU, each res-block's GroupNorm -> SiLU -> conv3x3 chain runs
as one call of ``ops.gn_silu_conv3x3``, at the sites the JAX package fuses:
norm0 -> conv0 when the block neither up- nor down-samples, and norm1 ->
conv1 always. On a CUDA tensor that is the hand-written kernel; on a CPU
tensor its plain version.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (gn_silu_conv3x3, gn_stats, naive_downsample_2d,
                   naive_upsample_2d)
from .dropout import Dropout
from .layers import NIN, DDPMConv, Dense, GroupNorm, spatial_attention


def _groups(ch: int) -> int:
  return min(ch // 4, 32)


def _gn_conv_eligible(block, h: torch.Tensor, train: bool) -> bool:
  c = h.shape[-1]
  return (not train and block.act is F.silu
          and c % 4 == 0 and c % _groups(c) == 0)


def _fused_gn_silu_conv(block, h: torch.Tensor, norm: GroupNorm,
                        conv: DDPMConv) -> torch.Tensor:
  """norm -> SiLU -> conv3x3 as one fused call; records the site's shape."""
  h = h.contiguous()
  g = _groups(h.shape[-1])
  mean, rsqrt = gn_stats(h, g, eps=norm.eps)
  out = gn_silu_conv3x3(h, mean, rsqrt, norm.weight, norm.bias,
                        conv.weight_hwio(), conv.bias, g)
  n, hh, ww, c = h.shape
  block.last_fused_sites.append((hh, ww, c, out.shape[-1]))
  return out


class GaussianFourierProjection(nn.Module):
  """Random-frequency Fourier embedding of (log) noise levels; W is frozen."""

  def __init__(self, embedding_size: int = 256, scale: float = 1.0):
    super().__init__()
    self.scale = scale
    self.W = nn.Parameter(torch.empty(embedding_size), requires_grad=False)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self.W.normal_(0.0, self.scale, generator=generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class AttnBlockpp(nn.Module):
  """Self-attention block with optional skip rescale."""

  def __init__(self, channels: int, skip_rescale: bool = False,
               init_scale: float = 0.0):
    super().__init__()
    self.skip_rescale = skip_rescale
    self.norm = GroupNorm(_groups(channels), channels)
    self.q = NIN(channels, channels)
    self.k = NIN(channels, channels)
    self.v = NIN(channels, channels)
    self.out = NIN(channels, channels, init_scale=init_scale)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = self.norm(x)
    h = spatial_attention(self.q(h), self.k(h), self.v(h))
    h = self.out(h)
    if self.skip_rescale:
      return (x + h) / math.sqrt(2.0)
    return x + h


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN-style residual block with in-block nearest/mean-pool resampling.

  ``last_fused_sites`` lists the (H, W, C, O) of every fused
  norm->SiLU->conv call of the latest forward."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, up: bool = False,
               down: bool = False, dropout: float = 0.1, fir: bool = False,
               skip_rescale: bool = True, init_scale: float = 0.0):
    super().__init__()
    if fir:
      raise NotImplementedError(
          "fir=True (FIR resampling) arrives with ROADMAP.md slice 4 "
          "(FIR family)")
    out_ch = out_ch or in_ch
    self.act = act
    self.up, self.down = up, down
    self.skip_rescale = skip_rescale
    self.norm0 = GroupNorm(_groups(in_ch), in_ch)
    self.conv0 = DDPMConv(in_ch, out_ch, 3)
    self.temb_proj = (Dense(temb_dim, out_ch) if temb_dim is not None
                      else None)
    self.norm1 = GroupNorm(_groups(out_ch), out_ch)
    self.dropout = Dropout(dropout)
    self.conv1 = DDPMConv(out_ch, out_ch, 3, init_scale=init_scale)
    self.shortcut = (DDPMConv(in_ch, out_ch, 1)
                     if in_ch != out_ch or up or down else None)
    self.last_fused_sites = []

  def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
    self.last_fused_sites = []
    # fused norm0->SiLU->conv0 only when no resampling sits between them
    fuse0 = (not self.up and not self.down
             and _gn_conv_eligible(self, x, train))
    if fuse0:
      h = _fused_gn_silu_conv(self, x, self.norm0, self.conv0)
    else:
      h = self.act(self.norm0(x))

    if self.up:
      h = naive_upsample_2d(h, factor=2)
      x = naive_upsample_2d(x, factor=2)
    elif self.down:
      h = naive_downsample_2d(h, factor=2)
      x = naive_downsample_2d(x, factor=2)

    if not fuse0:
      h = self.conv0(h)
    if self.temb_proj is not None:
      h = h + self.temb_proj(self.act(temb))[:, None, None, :]
    # dropout is the identity at eval, so norm1->SiLU->conv1 is contiguous
    if _gn_conv_eligible(self, h, train):
      h = _fused_gn_silu_conv(self, h, self.norm1, self.conv1)
    else:
      h = self.act(self.norm1(h))
      h = self.dropout(h, train)
      h = self.conv1(h)

    if self.shortcut is not None:
      x = self.shortcut(x)
    if self.skip_rescale:
      return (x + h) / math.sqrt(2.0)
    return x + h
