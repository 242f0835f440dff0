"""2x resampling on NHWC tensors: naive, FIR, and FIR fused with a conv.

Counterpart of ``soft_truncation_tpu/ops/resample.py``. The general
``upfirdn2d`` (upsample by zero insertion, pad or crop, FIR filter,
downsample) is plain torch ops: a depthwise ``F.conv2d`` with the flipped
kernel, since the FIR filter is a true convolution. ``upsample_2d`` /
``downsample_2d`` route statically: factor 2 with a 1-D kernel goes to
``ops.fir`` (the CUDA kernel for a CUDA tensor, its plain version for a
CPU tensor); any other factor or a 2-D kernel goes to ``upfirdn2d``.

Under a space axis (``parallel/spatial.py``: each rank holds H/s rows of
every image) the nearest / mean-pool resamples are local (H/s is even where
a level is halved), and each FIR resample, alone or fused with its conv,
runs on this rank's rows with a halo of the filter's reach (a multiple of
the stride, so the output keeps the whole image's phase) and is cropped to
this rank's output rows (:func:`_on_shard`); the ``fir2``
kernel and its adjoint run on the halo'd rows as they are.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial
from .fir import fir2_pads, fir_downsample2, fir_upsample2


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbour upsample, NHWC."""
  b, h, w, c = x.shape
  x = x.reshape(b, h, 1, w, 1, c).expand(b, h, factor, w, factor, c)
  return x.reshape(b, h * factor, w * factor, c)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Mean-pool downsample, NHWC."""
  b, h, w, c = x.shape
  x = x.reshape(b, h // factor, factor, w // factor, factor, c)
  return x.mean(dim=(2, 4))


def setup_fir_kernel(k: Union[Sequence[float], np.ndarray],
                     gain: float = 1.0) -> np.ndarray:
  """Normalise a 1-D (separable, made 2-D as an outer product) or 2-D FIR
  kernel to unit sum and multiply by ``gain``; float32 [kh, kw]."""
  k = np.asarray(k, dtype=np.float32)
  if k.ndim == 1:
    k = np.outer(k, k)
  if k.ndim != 2:
    raise ValueError(f"FIR kernel must be 1-D or 2-D, got shape {k.shape}")
  return k / np.sum(k) * gain


def reach(taps: int, up: int, down: int, pad0: int) -> Tuple[int, int]:
  """The input rows above and below a shard's own that its outputs read,
  for ``upfirdn2d`` with ``taps`` rows of filter and leading pad ``pad0``:
  output o reads the inputs i with ``i * up`` in ``[o * down - pad0, o *
  down - pad0 + taps - 1]``."""
  return (max(pad0 // up, 0),
          max((taps - 1 - pad0 - down) // up + 1, 0))


def _on_shard(fn: Callable, x: torch.Tensor, rows: Tuple[int, int],
              up: int = 1, down: int = 1) -> torch.Tensor:
  """``fn`` (a resample by up / down along H) of this rank's rows under a
  space axis: on them with ``rows`` = (above, below) halo rows, each
  rounded up to a multiple of the stride (the rows above so that the
  output keeps the whole image's phase, the rows below so that a
  downsample's input stays even), then cropped to this rank's output rows;
  ``fn(x)`` without a space axis."""
  space = spatial.current()
  if space is None:
    return fn(x)
  n = x.shape[1]
  if (n * up) % down:
    raise ValueError(f"a shard of {n} rows is not resampled by {up}/{down} "
                     "in whole rows")
  stride = down // math.gcd(up, down)
  above, below = (-(-r // stride) * stride for r in rows)
  y = fn(space.halo(x, above, below))
  return y.narrow(1, above * up // down, n * up // down)


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
  """[B, H, W, C] -> upsample x``up``, pad, FIR-filter, downsample /``down``.

  ``pad[0]`` leading and ``pad[1]`` trailing on both spatial axes; negative
  values crop. Output size ``(size * up + pad0 + pad1 - k) // down + 1``.
  """
  rows = reach(np.shape(kernel)[0], up, down, pad[0])
  return _on_shard(lambda x: _upfirdn2d(x, kernel, up, down, pad), x, rows,
                   up, down)


@functools.lru_cache(maxsize=None)
def _taps_on(values: Tuple[float, ...], shape: Tuple[int, ...],
             device: torch.device) -> torch.Tensor:
  """The filter as an f32 tensor on ``device``, made once (a copy from
  the host at every call could not be captured in a CUDA graph)."""
  return torch.tensor(values, dtype=torch.float32,
                      device=device).reshape(shape)


def _upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
               pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
  b, h, w, c = x.shape
  taps = np.asarray(kernel, dtype=np.float32)
  k = _taps_on(tuple(taps.ravel().tolist()), taps.shape, x.device)
  kh, kw = k.shape
  y = x.permute(0, 3, 1, 2)
  if up > 1:  # zeros after every sample, the last one included
    z = y.new_zeros((b, c, h * up, w * up))
    z[:, :, ::up, ::up] = y
    y = z
  y = F.pad(y, (pad[0], pad[1], pad[0], pad[1]))  # negative pads crop
  weight = torch.flip(k, (0, 1)).to(y.dtype).expand(c, 1, kh, kw)
  return F.conv2d(y, weight, stride=down, groups=c).permute(0, 2, 3, 1)


def _is_separable_2x(k, factor: int) -> bool:
  if factor != 2:
    return False
  if isinstance(k, (tuple, list)):  # the model's taps: no numpy per call
    return not (k and isinstance(k[0], (tuple, list, np.ndarray)))
  return np.asarray(k).ndim == 1


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
  """FIR upsample by ``factor``, NHWC (StyleGAN2's ``upsample_2d``)."""
  if k is None:
    k = [1.0] * factor
  if _is_separable_2x(k, factor):
    taps = len(k)
    return _on_shard(lambda x: fir_upsample2(x.contiguous(), k, gain), x,
                     reach(taps, 2, 1, fir2_pads(taps, "up")[0]), up=2)
  k = setup_fir_kernel(k, gain * (factor ** 2))
  p = k.shape[0] - factor
  return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2,
                  gain: float = 1.0) -> torch.Tensor:
  """FIR downsample by ``factor``, NHWC (StyleGAN2's ``downsample_2d``)."""
  if k is None:
    k = [1.0] * factor
  if _is_separable_2x(k, factor):
    taps = len(k)
    return _on_shard(lambda x: fir_downsample2(x.contiguous(), k, gain), x,
                     reach(taps, 1, 2, fir2_pads(taps, "down")[0]), down=2)
  k = setup_fir_kernel(k, gain)
  p = k.shape[0] - factor
  return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k=None,
                     factor: int = 2, gain: float = 1.0) -> torch.Tensor:
  """Zero-insertion upsample, conv, then FIR: StyleGAN2's fused upsample
  conv. ``w`` is HWIO ``[kh, kw, inC, outC]``."""
  kh, kw_, _, _ = w.shape
  if kh != kw_:
    raise ValueError(f"square conv kernels only, got {tuple(w.shape)}")
  if k is None:
    k = [1.0] * factor
  k = setup_fir_kernel(k, gain * (factor ** 2))
  p = (k.shape[0] - factor) - (kh - 1)
  pad0 = (p + 1) // 2 + factor - 1
  # the full correlation then the filter: one filter of k + kh - 1 taps
  return _on_shard(lambda x: _upsample_conv_2d(x, w, k, factor, p, pad0), x,
                   reach(k.shape[0] + kh - 1, factor, 1, pad0 + kh - 1),
                   up=factor)


def _upsample_conv_2d(x, w, k: np.ndarray, factor: int, p: int,
                      pad0: int) -> torch.Tensor:
  kh = w.shape[0]
  b, h, wd, c = x.shape
  # full correlation over the input with zeros between its samples
  z = x.new_zeros((b, c, (h - 1) * factor + 1, (wd - 1) * factor + 1))
  z[:, :, ::factor, ::factor] = x.permute(0, 3, 1, 2)
  y = F.conv2d(z, w.permute(3, 2, 0, 1).to(x.dtype), padding=kh - 1)
  return _upfirdn2d(y.permute(0, 2, 3, 1), k, pad=(pad0, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k=None,
                       factor: int = 2, gain: float = 1.0) -> torch.Tensor:
  """FIR, then a strided VALID conv: StyleGAN2's fused downsample conv.
  ``w`` is HWIO ``[kh, kw, inC, outC]``."""
  kh = w.shape[0]
  if k is None:
    k = [1.0] * factor
  k = setup_fir_kernel(k, gain)
  p = (k.shape[0] - factor) + (kh - 1)

  def fn(x):
    y = _upfirdn2d(x, k, pad=((p + 1) // 2, p // 2)).permute(0, 3, 1, 2)
    out = F.conv2d(y, w.permute(3, 2, 0, 1).to(x.dtype), stride=factor)
    return out.permute(0, 2, 3, 1)

  # the filtered rows, then the strided conv's kh taps over them
  return _on_shard(fn, x, reach(k.shape[0] + kh - 1, 1, factor, (p + 1) // 2),
                   down=factor)
