"""RefineNet blocks of the legacy NCSNv1/v2 networks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/refine.py``: chained residual
pooling (CRP), residual conv units (RCU), multi-scale fusion (MSF), the
RefineNet block and their class-conditional forms, ``ConvMeanPool``,
``MeanPoolConv``, ``UpsampleConv`` and the (conditional) residual blocks,
with the Flax module names. Flax reads channel counts off the inputs; here
each block takes its input channels when it is built.

The MSF block's corner-aligned bilinear resize is the JAX package's: two
interpolation matrices, one per axis. The 5x5 pools of CRP pad by 2: the
max pool with -inf, the average pool counting the padding (Flax's
``avg_pool`` divides by 25 everywhere).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, NCSNConv


def _align_corners_matrix(out_size: int, in_size: int) -> np.ndarray:
  """Row-stochastic linear-interpolation matrix, corners aligned."""
  m = np.zeros((out_size, in_size), dtype=np.float32)
  if out_size == 1 or in_size == 1:
    m[:, 0] = 1.0
    return m
  scale = (in_size - 1) / (out_size - 1)
  for i in range(out_size):
    pos = i * scale
    lo = int(np.floor(pos))
    hi = min(lo + 1, in_size - 1)
    frac = pos - lo
    m[i, lo] += 1.0 - frac
    m[i, hi] += frac
  return m


def bilinear_align_corners(x: torch.Tensor,
                           shape: Tuple[int, int]) -> torch.Tensor:
  """``F.interpolate(mode='bilinear', align_corners=True)`` on NHWC, as the
  JAX package computes it: over H, then over W."""
  b, h, w, c = x.shape
  oh, ow = shape
  if (oh, ow) == (h, w):
    return x
  mh = torch.from_numpy(_align_corners_matrix(oh, h)).to(x.device, x.dtype)
  mw = torch.from_numpy(_align_corners_matrix(ow, w)).to(x.device, x.dtype)
  x = torch.einsum("Oh,bhwc->bOwc", mh, x)
  return torch.einsum("Ow,bhwc->bhOc", mw, x)


def _pool5(x: torch.Tensor, kind: str) -> torch.Tensor:
  """5x5 stride-1 pool that keeps the size, on NHWC."""
  x = x.permute(0, 3, 1, 2)
  if kind == "max":
    x = F.max_pool2d(x, 5, stride=1, padding=2)
  else:
    x = F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)
  return x.permute(0, 2, 3, 1)


class CRPBlock(nn.Module):
  """Chained residual pooling: act, then ``n_stages`` of pool -> conv, each
  added back."""

  def __init__(self, features: int, n_stages: int, act: Callable,
               maxpool: bool = True):
    super().__init__()
    self.act, self.n_stages = act, n_stages
    self.kind = "max" if maxpool else "avg"
    for i in range(n_stages):
      self.add_module(f"conv_{i}", NCSNConv(features, features, 3,
                                            use_bias=False))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.act(x)
    path = x
    for i in range(self.n_stages):
      path = getattr(self, f"conv_{i}")(_pool5(path, self.kind))
      x = path + x
    return x


class CondCRPBlock(nn.Module):
  """The conditional CRP: norm -> average pool -> conv per stage."""

  def __init__(self, features: int, n_stages: int, normalizer: Callable,
               act: Callable):
    super().__init__()
    self.act, self.n_stages = act, n_stages
    for i in range(n_stages):
      self.add_module(f"norm_{i}", normalizer(features, bias=True))
      self.add_module(f"conv_{i}", NCSNConv(features, features, 3,
                                            use_bias=False))

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = self.act(x)
    path = x
    for i in range(self.n_stages):
      path = getattr(self, f"norm_{i}")(path, y)
      path = getattr(self, f"conv_{i}")(_pool5(path, "avg"))
      x = path + x
    return x


class RCUBlock(nn.Module):
  """Residual conv units: ``n_blocks`` of (act -> conv) x ``n_stages``,
  each block added to its input."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               act: Callable):
    super().__init__()
    self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
    for i in range(n_blocks):
      for j in range(n_stages):
        self.add_module(f"conv_{i}_{j}", NCSNConv(features, features, 3,
                                                  use_bias=False))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_blocks):
      residual = x
      for j in range(self.n_stages):
        x = getattr(self, f"conv_{i}_{j}")(self.act(x))
      x = x + residual
    return x


class CondRCUBlock(nn.Module):
  """The conditional RCU: norm -> act -> conv per stage."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               normalizer: Callable, act: Callable):
    super().__init__()
    self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
    for i in range(n_blocks):
      for j in range(n_stages):
        self.add_module(f"norm_{i}_{j}", normalizer(features, bias=True))
        self.add_module(f"conv_{i}_{j}", NCSNConv(features, features, 3,
                                                  use_bias=False))

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_blocks):
      residual = x
      for j in range(self.n_stages):
        x = getattr(self, f"norm_{i}_{j}")(x, y)
        x = getattr(self, f"conv_{i}_{j}")(self.act(x))
      x = x + residual
    return x


class MSFBlock(nn.Module):
  """Multi-scale fusion: a conv of each input, resized (corners aligned) to
  ``shape``, summed."""

  def __init__(self, in_chs: Sequence[int], features: int):
    super().__init__()
    self.n = len(in_chs)
    for i, c in enumerate(in_chs):
      self.add_module(f"conv_{i}", NCSNConv(c, features, 3, use_bias=True))

  def forward(self, xs: Sequence[torch.Tensor],
              shape: Tuple[int, int]) -> torch.Tensor:
    total = None
    for i, x in enumerate(xs):
      h = bilinear_align_corners(getattr(self, f"conv_{i}")(x), shape)
      total = h if total is None else total + h
    return total


class CondMSFBlock(nn.Module):
  """The conditional MSF: norm -> conv -> resize per input."""

  def __init__(self, in_chs: Sequence[int], features: int,
               normalizer: Callable):
    super().__init__()
    for i, c in enumerate(in_chs):
      self.add_module(f"norm_{i}", normalizer(c, bias=True))
      self.add_module(f"conv_{i}", NCSNConv(c, features, 3, use_bias=True))

  def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
              shape: Tuple[int, int]) -> torch.Tensor:
    total = None
    for i, x in enumerate(xs):
      h = getattr(self, f"conv_{i}")(getattr(self, f"norm_{i}")(x, y))
      h = bilinear_align_corners(h, shape)
      total = h if total is None else total + h
    return total


class RefineBlock(nn.Module):
  """RefineNet block: an RCU per input (``adapt_{i}``), MSF of several
  inputs, CRP, and an output RCU (3 units at the ``end``, else 1)."""

  def __init__(self, in_chs: Sequence[int], features: int, act: Callable,
               start: bool = False, end: bool = False, maxpool: bool = True):
    super().__init__()
    self.n = len(in_chs)
    for i, c in enumerate(in_chs):
      self.add_module(f"adapt_{i}", RCUBlock(c, 2, 2, act))
    self.msf = MSFBlock(in_chs, features) if self.n > 1 else None
    self.crp = CRPBlock(features, 2, act, maxpool=maxpool)
    self.output = RCUBlock(features, 3 if end else 1, 2, act)

  def forward(self, xs: Sequence[torch.Tensor],
              shape: Tuple[int, int]) -> torch.Tensor:
    hs = [getattr(self, f"adapt_{i}")(x) for i, x in enumerate(xs)]
    h = self.msf(hs, shape) if self.msf is not None else hs[0]
    return self.output(self.crp(h))


class CondRefineBlock(nn.Module):
  """The conditional RefineNet block."""

  def __init__(self, in_chs: Sequence[int], features: int,
               normalizer: Callable, act: Callable, start: bool = False,
               end: bool = False):
    super().__init__()
    self.n = len(in_chs)
    for i, c in enumerate(in_chs):
      self.add_module(f"adapt_{i}", CondRCUBlock(c, 2, 2, normalizer, act))
    self.msf = (CondMSFBlock(in_chs, features, normalizer) if self.n > 1
                else None)
    self.crp = CondCRPBlock(features, 2, normalizer, act)
    self.output = CondRCUBlock(features, 3 if end else 1, 2, normalizer, act)

  def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
              shape: Tuple[int, int]) -> torch.Tensor:
    hs = [getattr(self, f"adapt_{i}")(x, y) for i, x in enumerate(xs)]
    h = self.msf(hs, y, shape) if self.msf is not None else hs[0]
    return self.output(self.crp(h, y), y)


def _mean_pool_2x(x: torch.Tensor) -> torch.Tensor:
  """The mean of the four 2x2-phase subsamples."""
  return (x[:, ::2, ::2, :] + x[:, 1::2, ::2, :] + x[:, ::2, 1::2, :]
          + x[:, 1::2, 1::2, :]) / 4.0


class ConvMeanPool(nn.Module):
  """Conv, then the 2x mean-pool; with ``adjust_padding`` a row and a
  column of zeros at the top and left first."""

  def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
               use_bias: bool = True, adjust_padding: bool = False):
    super().__init__()
    self.adjust_padding = adjust_padding
    self.conv = NCSNConv(in_ch, features, kernel_size, use_bias=use_bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.adjust_padding:
      x = F.pad(x, (0, 0, 1, 0, 1, 0))
    return _mean_pool_2x(self.conv(x))


class MeanPoolConv(nn.Module):
  """The 2x mean-pool, then a conv."""

  def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
               use_bias: bool = True):
    super().__init__()
    self.conv = NCSNConv(in_ch, features, kernel_size, use_bias=use_bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.conv(_mean_pool_2x(x))


class UpsampleConv(nn.Module):
  """torch's 4x channel copy and PixelShuffle(2), then a conv: output
  phase (di, dj) of channel c takes input channel (4c + 2 di + dj) mod C,
  gathered on NHWC's channel axis."""

  def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
               use_bias: bool = True):
    super().__init__()
    self.conv = NCSNConv(in_ch, features, kernel_size, use_bias=use_bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    ch = torch.arange(c, device=x.device)
    phases = [x[..., (4 * ch + 2 * di + dj) % c]
              for di in range(2) for dj in range(2)]
    # [b, h, w, di, dj, c] -> [b, h, di, w, dj, c]
    out = torch.stack(phases, dim=3).reshape(b, h, w, 2, 2, c)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)
    return self.conv(out)


class ResidualBlock(nn.Module):
  """The NCSNv2 residual block: norm1 -> act -> conv1 -> norm2 -> act ->
  conv2, plus a shortcut; ``resample='down'`` halves the size (by
  ``ConvMeanPool``, or keeps it with a dilated conv), ``dilation`` > 1
  dilates every conv."""

  def __init__(self, in_ch: int, features: int, act: Callable,
               normalization: Callable, resample: Optional[str] = None,
               adjust_padding: bool = False, dilation: int = 1):
    super().__init__()
    self.act = act
    self.norm1 = normalization(in_ch)
    d = dilation
    if resample == "down":
      self.conv1 = NCSNConv(in_ch, in_ch, 3, dilation=d)
      self.norm2 = normalization(in_ch)
      if d > 1:
        self.conv2 = NCSNConv(in_ch, features, 3, dilation=d)
        self.shortcut = NCSNConv(in_ch, features, 3, dilation=d)
      else:
        self.conv2 = ConvMeanPool(in_ch, features, 3,
                                  adjust_padding=adjust_padding)
        self.shortcut = ConvMeanPool(in_ch, features, 1,
                                     adjust_padding=adjust_padding)
    elif resample is None:
      self.conv1 = NCSNConv(in_ch, features, 3, dilation=d)
      self.norm2 = normalization(features)
      self.conv2 = NCSNConv(features, features, 3, dilation=d)
      if features == in_ch:
        self.shortcut = None
      elif d > 1:
        self.shortcut = NCSNConv(in_ch, features, 3, dilation=d)
      else:
        self.shortcut = self._plain_shortcut(in_ch, features)
    else:
      raise ValueError("invalid resample value")

  @staticmethod
  def _plain_shortcut(in_ch: int, features: int) -> nn.Module:
    return NCSNConv(in_ch, features, 1)

  def _norm(self, name: str, x: torch.Tensor, y) -> torch.Tensor:
    return getattr(self, name)(x)

  def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    out = self.act(self._norm("norm1", x, y))
    out = self.act(self._norm("norm2", self.conv1(out), y))
    out = self.conv2(out)
    shortcut = x if self.shortcut is None else self.shortcut(x)
    return shortcut + out


class ConditionalResidualBlock(ResidualBlock):
  """The class-conditional NCSNv1 residual block: the norms take the labels
  ``y``, and an undilated width change without resampling takes a plain
  1x1 conv (Flax's default init) as its shortcut."""

  @staticmethod
  def _plain_shortcut(in_ch: int, features: int) -> nn.Module:
    return Conv2d(in_ch, features, 1, lecun=True)

  def _norm(self, name: str, x: torch.Tensor, y) -> torch.Tensor:
    return getattr(self, name)(x, y)

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return super().forward(x, y)
