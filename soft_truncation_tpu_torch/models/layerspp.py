"""NCSN++ building blocks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/layerspp.py``: every block of
its NCSN++: ``AttnBlockpp``, ``ResnetBlockBigGANpp`` (with or without FIR
resampling) and ``ResnetBlockDDPMpp``, ``Resample`` (the ``Upsample`` /
``Downsample`` of the pyramids and of the DDPM blocks' levels: FIR or
nearest / mean-pool, each with or without its conv), ``ConvResample`` and
``Combine``, the Gaussian Fourier time embedding and the fixed Fourier
input features.

At eval with SiLU, each res-block's GroupNorm -> SiLU -> conv3x3 chain runs
as one call of ``ops.gn_silu_conv3x3``, at the sites the JAX package fuses:
in a BigGAN block norm0 -> conv0 when the block neither up- nor
down-samples, and norm1 -> conv1 always; in a DDPM block both. On a CUDA
tensor that is the hand-written kernel; on a CPU
tensor its plain version. Each factor-2 FIR resample of a block or a
pyramid goes through ``ops.upsample_2d`` / ``downsample_2d``, which launch
the ``fir2`` kernel on a CUDA tensor; ``last_fir_sites`` records each
call's (mode, H, W, C).

At train (``train=True``) nothing is fused: each block runs norm -> act ->
(dropout) -> conv as plain torch ops, as the JAX package does, and its FIR
resamples take gradients through ``ops.fir``'s adjoint. Dropout draws its
mask from the ``generator`` passed down with the forward.

``act_quant`` (``config.tpu.activation_dtype``) makes a block's convs
``ops.quant.QConv``s, through ``layers.ddpm_conv``, where the JAX package
passes it; a fused site ignores it there and here (JAX's
``_gn_conv_eligible`` does not read it), so ``gn_silu_conv3x3`` runs
unquantized at eval.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (conv_downsample_2d, downsample_2d, gn_silu_conv3x3,
                   gn_stats, naive_downsample_2d, naive_upsample_2d,
                   upsample_2d, upsample_conv_2d)
from ..ops.gn_conv import fits as gn_conv_fits
from .dropout import Dropout
from .layers import (NIN, DDPMConv, Dense, GroupNorm, ddpm_conv,
                     default_init, spatial_attention)


# the JAX package's bound on a fused site's H * W * max(C, O)
_GN_CONV_MAX_HWC = 32 * 32 * 512


def _groups(ch: int) -> int:
  return min(ch // 4, 32)


def _gn_conv_eligible(block, h: torch.Tensor, out_ch: int,
                      train: bool) -> bool:
  """JAX's static guard (``soft_truncation_tpu/models/layerspp.py``), and a
  launch plan of the kernel that fits, for the primal and the tangent: a
  site that fails either runs the plain chain."""
  n, hh, ww, c = h.shape
  return (not train and block.act is F.silu
          and c % 4 == 0 and c % _groups(c) == 0
          and hh * ww * max(c, out_ch) <= _GN_CONV_MAX_HWC
          and gn_conv_fits(n, hh, ww, c, out_ch, _groups(c)))


def _fused_gn_silu_conv(block, h: torch.Tensor, norm: GroupNorm,
                        conv: DDPMConv) -> torch.Tensor:
  """norm -> SiLU -> conv3x3 as one fused call; records the site's shape."""
  h = h.contiguous()
  g = _groups(h.shape[-1])
  mean, rsqrt = gn_stats(h, g, eps=norm.eps)
  out = gn_silu_conv3x3(h, mean, rsqrt, norm.weight, norm.bias,
                        conv.weight_hwio(), conv.bias, g,
                        conv.weight_tf32_split() if h.is_cuda else None)
  n, hh, ww, c = h.shape
  block.last_fused_sites.append((hh, ww, c, out.shape[-1]))
  return out


def _fir_resample(module, x: torch.Tensor, mode: str,
                  fir_kernel: Sequence[float]) -> torch.Tensor:
  """Factor-2 FIR up/down-sample; records the site's (mode, H, W, C)."""
  n, h, w, c = x.shape
  module.last_fir_sites.append((mode, h, w, c))
  if mode == "up":
    return upsample_2d(x, k=tuple(fir_kernel), factor=2)
  return downsample_2d(x, k=tuple(fir_kernel), factor=2)


def fixed_fourier_features(x: torch.Tensor) -> torch.Tensor:
  """The JAX package's ``FixedFourierProjection``: x with sin and cos of
  x * 128 pi and x * 256 pi beside it on the channel axis (5C channels)."""
  return torch.cat([x, torch.sin(x * 128 * math.pi),
                    torch.cos(x * 128 * math.pi),
                    torch.sin(x * 256 * math.pi),
                    torch.cos(x * 256 * math.pi)], dim=-1)


class GaussianFourierProjection(nn.Module):
  """Random-frequency Fourier embedding of (log) noise levels; W is frozen."""

  def __init__(self, embedding_size: int = 256, scale: float = 1.0):
    super().__init__()
    self.scale = scale
    self.W = nn.Parameter(torch.empty(embedding_size), requires_grad=False)
    self.reset_parameters()

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


class Combine(nn.Module):
  """Merge a progressive-input pyramid branch: 1x1-conv x, then cat or sum
  with y."""

  def __init__(self, in_ch: int, out_ch: int, method: str = "cat",
               act_quant: Optional[str] = None):
    super().__init__()
    if method not in ("cat", "sum"):
      raise ValueError(f"combine method {method} not recognized")
    self.method = method
    self.conv = ddpm_conv(in_ch, out_ch, 1, act_quant=act_quant)

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = self.conv(x)
    if self.method == "cat":
      return torch.cat([h, y], dim=-1)
    return h + y


class ConvResample(nn.Module):
  """A conv fused with FIR 2x up- or down-sampling (StyleGAN2's Conv2d):
  ``upsample_conv_2d`` / ``conv_downsample_2d``, plain torch ops."""

  def __init__(self, mode: str, in_ch: int, out_ch: int, kernel: int = 3,
               fir_kernel: Sequence[float] = (1, 3, 3, 1)):
    super().__init__()
    self.up = mode == "up"
    self.fir_kernel = tuple(fir_kernel)
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
    self.bias = nn.Parameter(torch.zeros(out_ch))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i, kh, kw = self.weight.shape
    default_init()(self.weight, i * kh * kw, o * kh * kw, generator)
    with torch.no_grad():
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    w = self.weight.permute(2, 3, 1, 0)  # HWIO view
    if self.up:
      x = upsample_conv_2d(x, w, k=self.fir_kernel)
    else:
      x = conv_downsample_2d(x, w, k=self.fir_kernel)
    return x + self.bias


class Resample(nn.Module):
  """2x up- or down-sampling (the JAX package's ``Upsample`` /
  ``Downsample``). With ``fir``: ``upsample_2d`` / ``downsample_2d`` alone
  (the ``fir2`` kernel on a CUDA tensor), or fused with a 3x3 conv
  (``ConvResample``) when ``with_conv``. Without: nearest-neighbour up or
  mean-pool down, or with ``with_conv`` nearest up then a 3x3 conv, or a
  stride-2 3x3 conv down. The conv is named ``conv`` either way."""

  def __init__(self, mode: str, in_ch: int, out_ch: Optional[int] = None,
               with_conv: bool = False,
               fir_kernel: Sequence[float] = (1, 3, 3, 1), fir: bool = True,
               act_quant: Optional[str] = None):
    super().__init__()
    if mode not in ("up", "down"):
      raise ValueError(f"mode must be 'up' or 'down', got {mode!r}")
    self.mode = mode
    self.fir = fir
    self.fir_kernel = tuple(fir_kernel)
    out_ch = out_ch or in_ch
    if not with_conv:
      self.conv = None
    elif fir:
      self.conv = ConvResample(mode, in_ch, out_ch, 3, fir_kernel)
    else:
      self.conv = ddpm_conv(in_ch, out_ch, 3,
                            stride=2 if mode == "down" else 1,
                            act_quant=act_quant)
    self.last_fir_sites = []

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    self.last_fir_sites = []
    if self.fir:
      if self.conv is not None:
        return self.conv(x)
      return _fir_resample(self, x, self.mode, self.fir_kernel)
    if self.mode == "up":
      x = naive_upsample_2d(x, factor=2)
      return self.conv(x) if self.conv is not None else x
    if self.conv is not None:
      return self.conv(x)
    return naive_downsample_2d(x, factor=2)


class ResnetBlockDDPMpp(nn.Module):
  """DDPM-style residual block with skip rescale and a 1x1 (``NIN``)
  shortcut when the width changes (JAX's ``conv_shortcut``, which no NCSN++
  sets, is not ported). ``last_fused_sites`` as for
  :class:`ResnetBlockBigGANpp`; both of its norm -> SiLU -> conv chains are
  fused sites."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, dropout: float = 0.1,
               skip_rescale: bool = False, init_scale: float = 0.0,
               act_quant: Optional[str] = None):
    super().__init__()
    out_ch = out_ch or in_ch
    self.act = act
    self.skip_rescale = skip_rescale
    self.norm0 = GroupNorm(_groups(in_ch), in_ch)
    self.conv0 = ddpm_conv(in_ch, out_ch, 3, act_quant=act_quant)
    self.temb_proj = (Dense(temb_dim, out_ch) if temb_dim is not None
                      else None)
    self.norm1 = GroupNorm(_groups(out_ch), out_ch)
    self.dropout = Dropout(dropout)
    self.conv1 = ddpm_conv(out_ch, out_ch, 3, init_scale=init_scale,
                           act_quant=act_quant)
    self.shortcut = NIN(in_ch, out_ch) if in_ch != out_ch else None
    self.last_fused_sites = []

  def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    self.last_fused_sites = []
    out_ch = self.conv0.weight.shape[0]
    if _gn_conv_eligible(self, x, out_ch, train):
      h = _fused_gn_silu_conv(self, x, self.norm0, self.conv0)
    else:
      h = self.conv0(self.act(self.norm0(x)))
    if self.temb_proj is not None:
      h = h + self.temb_proj(self.act(temb))[:, None, None, :]
    if _gn_conv_eligible(self, h, out_ch, train):
      h = _fused_gn_silu_conv(self, h, self.norm1, self.conv1)
    else:
      h = self.act(self.norm1(h))
      h = self.dropout(h, train, generator)
      h = self.conv1(h)
    if self.shortcut is not None:
      x = self.shortcut(x)
    if self.skip_rescale:
      return (x + h) / math.sqrt(2.0)
    return x + h


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN-style residual block with in-block resampling: FIR with
  ``fir``, else nearest / mean-pool.

  ``last_fused_sites`` lists the (H, W, C, O) of every fused
  norm->SiLU->conv call of the latest forward, ``last_fir_sites`` the
  (mode, H, W, C) of every FIR resample."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, up: bool = False,
               down: bool = False, dropout: float = 0.1, fir: bool = False,
               fir_kernel: Sequence[float] = (1, 3, 3, 1),
               skip_rescale: bool = True, init_scale: float = 0.0,
               act_quant: Optional[str] = None):
    super().__init__()
    out_ch = out_ch or in_ch
    self.act = act
    self.up, self.down = up, down
    self.fir, self.fir_kernel = fir, tuple(fir_kernel)
    self.skip_rescale = skip_rescale
    self.norm0 = GroupNorm(_groups(in_ch), in_ch)
    self.conv0 = ddpm_conv(in_ch, out_ch, 3, act_quant=act_quant)
    self.temb_proj = (Dense(temb_dim, out_ch) if temb_dim is not None
                      else None)
    self.norm1 = GroupNorm(_groups(out_ch), out_ch)
    self.dropout = Dropout(dropout)
    self.conv1 = ddpm_conv(out_ch, out_ch, 3, init_scale=init_scale,
                           act_quant=act_quant)
    self.shortcut = (ddpm_conv(in_ch, out_ch, 1, act_quant=act_quant)
                     if in_ch != out_ch or up or down else None)
    self.last_fused_sites = []
    self.last_fir_sites = []

  def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    self.last_fused_sites = []
    self.last_fir_sites = []
    # fused norm0->SiLU->conv0 only when no resampling sits between them
    fuse0 = (not self.up and not self.down and _gn_conv_eligible(
        self, x, self.conv0.weight.shape[0], train))
    if fuse0:
      h = _fused_gn_silu_conv(self, x, self.norm0, self.conv0)
    else:
      h = self.act(self.norm0(x))

    if self.fir and (self.up or self.down):
      mode = "up" if self.up else "down"
      h = _fir_resample(self, h, mode, self.fir_kernel)
      x = _fir_resample(self, x, mode, self.fir_kernel)
    elif self.up:
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
    if _gn_conv_eligible(self, h, self.conv1.weight.shape[0], train):
      h = _fused_gn_silu_conv(self, h, self.norm1, self.conv1)
    else:
      h = self.act(self.norm1(h))
      h = self.dropout(h, train, generator)
      h = self.conv1(h)

    if self.shortcut is not None:
      x = self.shortcut(x)
    if self.skip_rescale:
      return (x + h) / math.sqrt(2.0)
    return x + h
