"""The legacy DDPM U-Net (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/ddpm.py`` (Ho et al. 2020),
registered as ``ddpm``: sinusoidal time embedding through two Dense layers,
``ResnetBlockDDPM`` blocks (GroupNorm with 32 groups, dropout), legacy
attention at ``attn_resolutions``, nearest / strided-conv resampling (the
JAX package's legacy ``Upsample`` / ``Downsample``: ``layerspp.Resample``
without FIR), and with ``scale_by_sigma`` the output divided by the noise
level of each label.
Module names are the Flax ones (``temb_dense0/1``, ``stem``,
``down_{i}_{j}``, ``down_attn_{i}_{j}``, ``down_{i}_ds``, ``mid_res0``,
``mid_attn``, ``mid_res1``, ``up_{i}_{j}``, ``up_attn_{i}``,
``up_{i}_us``, ``out_norm``, ``out_conv``). Nothing is fused: the JAX
package runs these blocks as plain XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (AttnBlock, DDPMConv, Dense, GroupNorm, ResnetBlockDDPM,
                     get_act, get_timestep_embedding)
from .layerspp import Resample
from .ncsnpp import get_sigmas
from .registry import register_model


@register_model(name="ddpm")
class DDPM(nn.Module):

  def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
               num_res_blocks: int = 2,
               attn_resolutions: Sequence[int] = (16,), dropout: float = 0.1,
               resamp_with_conv: bool = True, conditional: bool = True,
               image_size: int = 32, num_channels: int = 3,
               nonlinearity: str = "swish", scale_by_sigma: bool = False,
               sigma_min: float = 0.01, sigma_max: float = 50.0,
               num_scales: int = 1000, centered: bool = True):
    super().__init__()
    self.act = act = get_act(nonlinearity)
    self.nf = nf
    self.num_resolutions = len(ch_mult)
    self.num_res_blocks = num_res_blocks
    self.conditional = conditional
    self.centered = centered
    self.scale_by_sigma = scale_by_sigma
    self.sigmas = (sigma_min, sigma_max, num_scales)
    temb_dim = 4 * nf if conditional else None
    if conditional:
      self.temb_dense0 = Dense(nf, 4 * nf)
      self.temb_dense1 = Dense(4 * nf, 4 * nf)

    def block(in_ch, out_ch=None):
      return ResnetBlockDDPM(act, in_ch, out_ch, temb_dim=temb_dim,
                             dropout=dropout)

    self.stem = DDPMConv(num_channels, nf, 3)
    hs, ch, res = [nf], nf, image_size
    self._attn_down, self._attn_up = set(), set()
    for i in range(self.num_resolutions):
      for j in range(num_res_blocks):
        self.add_module(f"down_{i}_{j}", block(ch, nf * ch_mult[i]))
        ch = nf * ch_mult[i]
        if res in attn_resolutions:
          self.add_module(f"down_attn_{i}_{j}", AttnBlock(ch))
          self._attn_down.add((i, j))
        hs.append(ch)
      if i != self.num_resolutions - 1:
        self.add_module(f"down_{i}_ds", Resample("down", ch, fir=False,
                                                 with_conv=resamp_with_conv))
        res //= 2
        hs.append(ch)
    self.mid_res0 = block(ch)
    self.mid_attn = AttnBlock(ch)
    self.mid_res1 = block(ch)
    for i in reversed(range(self.num_resolutions)):
      for j in range(num_res_blocks + 1):
        self.add_module(f"up_{i}_{j}", block(ch + hs.pop(), nf * ch_mult[i]))
        ch = nf * ch_mult[i]
      if res in attn_resolutions:
        self.add_module(f"up_attn_{i}", AttnBlock(ch))
        self._attn_up.add(i)
      if i != 0:
        self.add_module(f"up_{i}_us", Resample("up", ch, fir=False,
                                               with_conv=resamp_with_conv))
        res *= 2
    assert not hs
    self.out_norm = GroupNorm(32, ch)
    self.out_conv = DDPMConv(ch, num_channels, 3, init_scale=0.0)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every parameter from ``generator`` in module order."""
    for m in self.modules():
      if m is not self and hasattr(m, "reset_parameters"):
        m.reset_parameters(generator)

  def forward(self, x: torch.Tensor, labels: torch.Tensor,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    act = self.act
    temb = None
    if self.conditional:
      temb = get_timestep_embedding(labels, self.nf)
      temb = self.temb_dense1(act(self.temb_dense0(temb)))
    h = x if self.centered else 2 * x - 1.0
    hs = [self.stem(h)]
    for i in range(self.num_resolutions):
      for j in range(self.num_res_blocks):
        h = getattr(self, f"down_{i}_{j}")(hs[-1], temb, train, generator)
        if (i, j) in self._attn_down:
          h = getattr(self, f"down_attn_{i}_{j}")(h)
        hs.append(h)
      if i != self.num_resolutions - 1:
        hs.append(getattr(self, f"down_{i}_ds")(hs[-1]))
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
      if i != 0:
        h = getattr(self, f"up_{i}_us")(h)
    h = self.out_conv(act(self.out_norm(h)))
    if self.scale_by_sigma:
      sigmas = torch.as_tensor(get_sigmas(*self.sigmas), dtype=torch.float32,
                               device=h.device)
      # clamped like the JAX package's gather
      used = sigmas[labels.long().clamp(0, sigmas.shape[0] - 1)]
      h = h / used.reshape((-1,) + (1,) * (h.dim() - 1))
    return h

  @classmethod
  def from_config(cls, config) -> "DDPM":
    m, d = config.model, config.data
    return cls(
        nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
        resamp_with_conv=m.resamp_with_conv, conditional=m.conditional,
        image_size=d.image_size, num_channels=d.num_channels,
        nonlinearity=m.nonlinearity, scale_by_sigma=m.scale_by_sigma,
        sigma_min=m.sigma_min, sigma_max=m.sigma_max,
        num_scales=m.num_scales, centered=d.centered)
