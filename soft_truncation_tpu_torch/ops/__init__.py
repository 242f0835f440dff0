"""Ops of the PyTorch port: resampling and the fused GN->SiLU->conv kernel."""

from .gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain, gn_stats
from .resample import naive_downsample_2d, naive_upsample_2d

__all__ = ["gn_silu_conv3x3", "gn_silu_conv3x3_plain", "gn_stats",
           "naive_downsample_2d", "naive_upsample_2d"]
