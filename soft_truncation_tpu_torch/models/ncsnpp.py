"""NCSN++ / DDPM++ U-Net (NHWC), in PyTorch: the flagship's options.

Counterpart of ``soft_truncation_tpu/models/ncsnpp.py``, with the same block
names as the Flax module (``temb_dense0/1``, ``stem``, ``down_{i}_{j}``,
``down_attn_{i}_{j}``, ``down_{i}_ds``, ``mid_res0``, ``mid_attn``,
``mid_res1``, ``up_{i}_{j}``, ``up_attn_{i}``, ``up_{i}_us``, ``out_norm``,
``out_conv``), so a Flax parameter tree maps onto the state_dict by path.

Ported: positional and Fourier time embeddings, ``conditional``, BigGAN
res-blocks with ``auxiliary_resblock`` and FIR or naive resampling,
attention, the progressive input (``input_skip`` / ``residual``, combined by
``sum`` or ``cat``) and output (``output_skip`` / ``residual``) pyramids
with FIR, ``skip_rescale``, ``centered`` and ``scale_by_sigma``, at eval
and at train (``train=True``: dropout, whose mask comes from the
``generator`` passed to the forward, and no fused sites). Other
options raise ``NotImplementedError`` naming the ROADMAP.md slice that
brings them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import layerspp
from .layers import (DDPMConv, Dense, GroupNorm, get_act,
                     get_timestep_embedding)
from .registry import register_model


def get_sigmas(sigma_min: float, sigma_max: float,
               num_scales: int) -> np.ndarray:
  """Descending geometric noise grid."""
  return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


def _refuse(option: str, slice_: str):
  raise NotImplementedError(f"{option} arrives with ROADMAP.md {slice_}")


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
  """Config-driven NCSN++ family U-Net (BigGAN blocks)."""

  def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
               num_res_blocks: int = 4,
               attn_resolutions: Sequence[int] = (16,),
               attention: bool = True, dropout: float = 0.1,
               image_size: int = 32, num_channels: int = 3,
               conditional: bool = True, fir: bool = False,
               fir_kernel: Sequence[float] = (1, 3, 3, 1),
               skip_rescale: bool = True, progressive: str = "none",
               progressive_input: str = "none",
               progressive_combine: str = "sum",
               embedding_type: str = "fourier", fourier_scale: float = 16.0,
               init_scale: float = 0.0, nonlinearity: str = "swish",
               scale_by_sigma: bool = False, sigma_min: float = 0.01,
               sigma_max: float = 50.0, num_scales: int = 1000,
               centered: bool = True):
    super().__init__()
    if embedding_type not in ("fourier", "positional"):
      raise ValueError(f"unknown embedding_type {embedding_type!r}")
    if progressive not in ("none", "output_skip", "residual"):
      raise ValueError(f"unknown progressive {progressive!r}")
    if progressive_input not in ("none", "input_skip", "residual"):
      raise ValueError(f"unknown progressive_input {progressive_input!r}")
    act = get_act(nonlinearity)
    self.nf = nf
    self.embedding_type = embedding_type
    self.conditional = conditional
    self.centered = centered
    self.scale_by_sigma = scale_by_sigma
    self.sigmas = (sigma_min, sigma_max, num_scales)
    self.act = act
    self.num_resolutions = len(ch_mult)
    self.num_res_blocks = num_res_blocks
    self.skip_rescale = skip_rescale
    self.progressive = progressive
    self.progressive_input = progressive_input

    if embedding_type == "fourier":
      self.fourier_emb = layerspp.GaussianFourierProjection(
          embedding_size=nf, scale=fourier_scale)
    temb_dim = None
    if conditional:
      temb_dim = nf * 4
      self.temb_dense0 = Dense(nf * 2 if embedding_type == "fourier" else nf,
                               temb_dim)
      self.temb_dense1 = Dense(temb_dim, temb_dim)

    def res_block(in_ch, out_ch=None, up=False, down=False):
      return layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, temb_dim=temb_dim, up=up, down=down,
          dropout=dropout, fir=fir, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale)

    def attn_block(ch):
      return layerspp.AttnBlockpp(ch, skip_rescale=skip_rescale,
                                  init_scale=init_scale)

    # channel bookkeeping mirrors the Flax module's dataflow
    self.stem = DDPMConv(num_channels, nf, 3)
    hs_ch = [nf]
    ch, res = nf, image_size
    pyr_ch = num_channels  # channels of the input pyramid
    self._attn_down, self._attn_up = set(), set()
    for i in range(self.num_resolutions):
      for j in range(num_res_blocks):
        out = nf * ch_mult[i]
        self.add_module(f"down_{i}_{j}", res_block(ch, out))
        ch = out
        if res in attn_resolutions and attention:
          self.add_module(f"down_attn_{i}_{j}", attn_block(ch))
          self._attn_down.add((i, j))
        hs_ch.append(ch)
      if i != self.num_resolutions - 1:
        self.add_module(f"down_{i}_ds", res_block(ch, down=True))
        if progressive_input == "input_skip":
          self.add_module(f"pyr_ds_{i}", layerspp.Resample(
              "down", num_channels, fir_kernel=fir_kernel))
          self.add_module(f"combine_{i}", layerspp.Combine(
              num_channels, ch, method=progressive_combine))
          if progressive_combine == "cat":
            ch *= 2
        elif progressive_input == "residual":
          self.add_module(f"pyr_ds_{i}", layerspp.Resample(
              "down", pyr_ch, ch, with_conv=True, fir_kernel=fir_kernel))
          pyr_ch = ch
        hs_ch.append(ch)
        res //= 2

    self.mid_res0 = res_block(ch)
    self.mid_attn = attn_block(ch)
    self.mid_res1 = res_block(ch)

    for i in reversed(range(self.num_resolutions)):
      for j in range(num_res_blocks + 1):
        out = nf * ch_mult[i]
        self.add_module(f"up_{i}_{j}", res_block(ch + hs_ch.pop(), out))
        ch = out
      if res in attn_resolutions and attention:
        self.add_module(f"up_attn_{i}", attn_block(ch))
        self._attn_up.add(i)
      if progressive != "none":
        if i == self.num_resolutions - 1:
          out = num_channels if progressive == "output_skip" else ch
          self.add_module(f"pyr_norm_{i}", GroupNorm(min(ch // 4, 32), ch))
          self.add_module(f"pyr_conv_{i}", DDPMConv(
              ch, out, 3,
              init_scale=init_scale if progressive == "output_skip" else 1.0))
          pyr_ch = out
        elif progressive == "output_skip":
          self.add_module(f"pyr_us_{i}", layerspp.Resample(
              "up", num_channels, fir_kernel=fir_kernel))
          self.add_module(f"pyr_norm_{i}", GroupNorm(min(ch // 4, 32), ch))
          self.add_module(f"pyr_conv_{i}", DDPMConv(ch, num_channels, 3,
                                                    init_scale=init_scale))
        else:
          self.add_module(f"pyr_us_{i}", layerspp.Resample(
              "up", pyr_ch, ch, with_conv=True, fir_kernel=fir_kernel))
          pyr_ch = ch
      if i != 0:
        self.add_module(f"up_{i}_us", res_block(ch, up=True))
        res *= 2
    assert not hs_ch

    if progressive != "output_skip":
      self.out_norm = GroupNorm(min(ch // 4, 32), ch)
      self.out_conv = DDPMConv(ch, num_channels, 3, init_scale=init_scale)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every parameter from ``generator`` in module order."""
    for m in self.modules():
      if m is not self and hasattr(m, "reset_parameters"):
        m.reset_parameters(generator)

  def fused_sites(self) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, O) of each fused norm->SiLU->conv call of the last forward."""
    return [s for m in self.modules()
            if isinstance(m, layerspp.ResnetBlockBigGANpp)
            for s in m.last_fused_sites]

  def fir_sites(self) -> List[Tuple[str, int, int, int]]:
    """(mode, H, W, C) of each FIR 2x resample of the last forward."""
    return [s for m in self.modules() for s in getattr(m, "last_fir_sites",
                                                       ())]

  def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    act = self.act
    if self.embedding_type == "fourier":
      used_sigmas = time_cond
      temb = self.fourier_emb(torch.log(used_sigmas))
    else:
      temb = get_timestep_embedding(time_cond, self.nf)

    if self.conditional:
      temb = self.temb_dense1(act(self.temb_dense0(temb)))
    else:
      temb = None

    if not self.centered:
      x = 2 * x - 1.0

    input_pyramid = x if self.progressive_input != "none" else None
    hs = [self.stem(x)]
    for i in range(self.num_resolutions):
      for j in range(self.num_res_blocks):
        h = getattr(self, f"down_{i}_{j}")(hs[-1], temb, train, generator)
        if (i, j) in self._attn_down:
          h = getattr(self, f"down_attn_{i}_{j}")(h)
        hs.append(h)
      if i != self.num_resolutions - 1:
        h = getattr(self, f"down_{i}_ds")(hs[-1], temb, train, generator)
        if self.progressive_input == "input_skip":
          input_pyramid = getattr(self, f"pyr_ds_{i}")(input_pyramid)
          h = getattr(self, f"combine_{i}")(input_pyramid, h)
        elif self.progressive_input == "residual":
          input_pyramid = self._merge(getattr(self, f"pyr_ds_{i}")(
              input_pyramid), h)
          h = input_pyramid
        hs.append(h)

    h = hs[-1]
    h = self.mid_res0(h, temb, train, generator)
    h = self.mid_attn(h)
    h = self.mid_res1(h, temb, train, generator)

    for i in reversed(range(self.num_resolutions)):
      for j in range(self.num_res_blocks + 1):
        h = getattr(self, f"up_{i}_{j}")(torch.cat([h, hs.pop()], dim=-1),
                                         temb, train, generator)
      if i in self._attn_up:
        h = getattr(self, f"up_attn_{i}")(h)
      if self.progressive != "none":
        top = i == self.num_resolutions - 1
        if self.progressive == "output_skip":
          pyramid_h = getattr(self, f"pyr_conv_{i}")(
              act(getattr(self, f"pyr_norm_{i}")(h)))
          pyramid = (pyramid_h if top else
                     getattr(self, f"pyr_us_{i}")(pyramid) + pyramid_h)
        elif top:
          pyramid = getattr(self, f"pyr_conv_{i}")(
              act(getattr(self, f"pyr_norm_{i}")(h)))
        else:
          pyramid = self._merge(getattr(self, f"pyr_us_{i}")(pyramid), h)
          h = pyramid
      if i != 0:
        h = getattr(self, f"up_{i}_us")(h, temb, train, generator)

    if self.progressive == "output_skip":
      h = pyramid
    else:
      h = act(self.out_norm(h))
      h = self.out_conv(h)

    if self.scale_by_sigma:
      if self.embedding_type == "positional":
        sigmas = torch.as_tensor(get_sigmas(*self.sigmas), dtype=torch.float32,
                                 device=h.device)
        # clamped like the JAX package's gather
        idx = time_cond.long().clamp(0, sigmas.shape[0] - 1)
        used_sigmas = sigmas[idx]
      h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (h.dim() - 1))
    return h

  def _merge(self, pyramid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A residual pyramid step: the sum, rescaled with ``skip_rescale``."""
    if self.skip_rescale:
      return (pyramid + h) / math.sqrt(2.0)
    return pyramid + h

  @classmethod
  def from_config(cls, config) -> "NCSNpp":
    """Build from a config with the JAX package's schema."""
    m, d = config.model, config.data
    if m.resblock_type.lower() != "biggan":
      _refuse(f"resblock_type={m.resblock_type!r}", "slice 6 (the rest)")
    if not m.fir and (m.progressive.lower() != "none"
                      or m.progressive_input.lower() != "none"):
      _refuse("progressive paths without FIR (fir=False)",
              "slice 6 (the rest)")
    if not m.get("auxiliary_resblock", True):
      _refuse("auxiliary_resblock=False", "slice 6 (the rest)")
    if m.get("fourier_feature", False) or m.get("lsgm", False):
      _refuse("fourier_feature / lsgm embeddings", "slice 6 (the rest)")
    return cls(
        nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        attention=m.get("attention", True), dropout=m.dropout,
        image_size=d.image_size, num_channels=d.num_channels,
        conditional=m.conditional, fir=m.fir,
        fir_kernel=tuple(m.fir_kernel), skip_rescale=m.skip_rescale,
        progressive=m.progressive.lower(),
        progressive_input=m.progressive_input.lower(),
        progressive_combine=m.progressive_combine.lower(),
        embedding_type=m.embedding_type.lower(),
        fourier_scale=m.get("fourier_scale", 16.0),
        init_scale=m.init_scale, nonlinearity=m.nonlinearity,
        scale_by_sigma=m.scale_by_sigma, sigma_min=m.sigma_min,
        sigma_max=m.sigma_max, num_scales=m.num_scales, centered=d.centered)
