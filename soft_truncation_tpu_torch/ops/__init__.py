"""Ops of the PyTorch port: resampling and the hand-written kernels."""

from typing import Dict

from . import fir
from .fir import fir_downsample2, fir_upsample2
from .gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain, gn_stats
from .resample import (conv_downsample_2d, downsample_2d, naive_downsample_2d,
                       naive_upsample_2d, setup_fir_kernel, upfirdn2d,
                       upsample_2d, upsample_conv_2d)

__all__ = ["launch_totals", "conv_downsample_2d", "downsample_2d", "fir_downsample2",
           "fir_upsample2", "gn_silu_conv3x3", "gn_silu_conv3x3_plain",
           "gn_stats", "naive_downsample_2d", "naive_upsample_2d",
           "setup_fir_kernel", "upfirdn2d", "upsample_2d", "upsample_conv_2d"]


def launch_totals() -> Dict[str, int]:
  """Every kernel wrapper's launch totals so far, by
  ``<wrapper>.<count>`` (``gn_silu_conv3x3.launches``,
  ``fir_upsample2.backward_launches``, ...): what the wrappers counted
  where they launched, or, under a CUDA graph's capture, recorded."""
  counts = {f"gn_silu_conv3x3.{n}": getattr(gn_silu_conv3x3, n)
            for n in ("launches", "jvp_launches")}
  for wrapper in (fir_upsample2, fir_downsample2):
    for total, _ in fir._TALLIES.values():
      counts[f"{wrapper.__name__}.{total}"] = getattr(wrapper, total)
  return counts
