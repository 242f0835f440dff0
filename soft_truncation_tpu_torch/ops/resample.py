"""Non-FIR 2x resampling on NHWC tensors.

Counterpart of ``soft_truncation_tpu/ops/resample.py:90-102``. The FIR
family (``upfirdn2d`` and its Pallas kernels) comes with ROADMAP.md slice 4.
"""

from __future__ import annotations

import torch


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
