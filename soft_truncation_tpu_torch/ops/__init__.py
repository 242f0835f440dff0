"""Ops of the PyTorch port: resampling and the hand-written kernels."""

from .fir import fir_downsample2, fir_upsample2
from .gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain, gn_stats
from .resample import (conv_downsample_2d, downsample_2d, naive_downsample_2d,
                       naive_upsample_2d, setup_fir_kernel, upfirdn2d,
                       upsample_2d, upsample_conv_2d)

__all__ = ["conv_downsample_2d", "downsample_2d", "fir_downsample2",
           "fir_upsample2", "gn_silu_conv3x3", "gn_silu_conv3x3_plain",
           "gn_stats", "naive_downsample_2d", "naive_upsample_2d",
           "setup_fir_kernel", "upfirdn2d", "upsample_2d", "upsample_conv_2d"]
