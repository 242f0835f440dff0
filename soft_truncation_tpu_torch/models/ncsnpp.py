"""NCSN++ / DDPM++ U-Net (NHWC), in PyTorch: the flagship's options.

Counterpart of ``soft_truncation_tpu/models/ncsnpp.py``, with the same block
names as the Flax module (``temb_dense0/1``, ``stem``, ``down_{i}_{j}``,
``down_attn_{i}_{j}``, ``down_{i}_ds``, ``mid_res0``, ``mid_attn``,
``mid_res1``, ``up_{i}_{j}``, ``up_attn_{i}``, ``up_{i}_us``, ``out_norm``,
``out_conv``), so a Flax parameter tree maps onto the state_dict by path.

Ported: positional and Fourier time embeddings, ``conditional``, BigGAN
res-blocks with ``auxiliary_resblock``, attention, ``skip_rescale``,
``centered`` and ``scale_by_sigma``. Other options raise
``NotImplementedError`` naming the ROADMAP.md slice that brings them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import layerspp
from .layers import DDPMConv, Dense, GroupNorm, get_act, get_timestep_embedding
from .registry import register_model


def get_sigmas(sigma_min: float, sigma_max: float,
               num_scales: int) -> np.ndarray:
  """Descending geometric noise grid."""
  return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


def _refuse(option: str, slice_: str):
  raise NotImplementedError(f"{option} arrives with ROADMAP.md {slice_}")


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
  """Config-driven NCSN++ family U-Net (BigGAN blocks, no FIR)."""

  def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
               num_res_blocks: int = 4,
               attn_resolutions: Sequence[int] = (16,),
               attention: bool = True, dropout: float = 0.1,
               image_size: int = 32, num_channels: int = 3,
               conditional: bool = True, skip_rescale: bool = True,
               embedding_type: str = "fourier", fourier_scale: float = 16.0,
               init_scale: float = 0.0, nonlinearity: str = "swish",
               scale_by_sigma: bool = False, sigma_min: float = 0.01,
               sigma_max: float = 50.0, num_scales: int = 1000,
               centered: bool = True):
    super().__init__()
    if embedding_type not in ("fourier", "positional"):
      raise ValueError(f"unknown embedding_type {embedding_type!r}")
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
          dropout=dropout, skip_rescale=skip_rescale, init_scale=init_scale)

    def attn_block(ch):
      return layerspp.AttnBlockpp(ch, skip_rescale=skip_rescale,
                                  init_scale=init_scale)

    # channel bookkeeping mirrors the Flax module's dataflow
    self.stem = DDPMConv(num_channels, nf, 3)
    hs_ch = [nf]
    ch, res = nf, image_size
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
      if i != 0:
        self.add_module(f"up_{i}_us", res_block(ch, up=True))
        res *= 2
    assert not hs_ch

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

  def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    if train:
      _refuse("the training forward (train=True)", "slice 2 (ST train step)")
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

    hs = [self.stem(x)]
    for i in range(self.num_resolutions):
      for j in range(self.num_res_blocks):
        h = getattr(self, f"down_{i}_{j}")(hs[-1], temb, train)
        if (i, j) in self._attn_down:
          h = getattr(self, f"down_attn_{i}_{j}")(h)
        hs.append(h)
      if i != self.num_resolutions - 1:
        hs.append(getattr(self, f"down_{i}_ds")(hs[-1], temb, train))

    h = hs[-1]
    h = self.mid_res0(h, temb, train)
    h = self.mid_attn(h)
    h = self.mid_res1(h, temb, train)

    for i in reversed(range(self.num_resolutions)):
      for j in range(self.num_res_blocks + 1):
        h = getattr(self, f"up_{i}_{j}")(torch.cat([h, hs.pop()], dim=-1),
                                         temb, train)
      if i in self._attn_up:
        h = getattr(self, f"up_attn_{i}")(h)
      if i != 0:
        h = getattr(self, f"up_{i}_us")(h, temb, train)

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

  @classmethod
  def from_config(cls, config) -> "NCSNpp":
    """Build from a config with the JAX package's schema."""
    m, d = config.model, config.data
    if m.resblock_type.lower() != "biggan":
      _refuse(f"resblock_type={m.resblock_type!r}", "slice 6 (the rest)")
    if m.fir:
      _refuse("fir=True (FIR resampling)", "slice 4 (FIR family)")
    if (m.progressive.lower() != "none"
        or m.progressive_input.lower() != "none"):
      _refuse("progressive input/output paths", "slice 4 (FIR family)")
    if not m.get("auxiliary_resblock", True):
      _refuse("auxiliary_resblock=False", "slice 6 (the rest)")
    if m.get("fourier_feature", False) or m.get("lsgm", False):
      _refuse("fourier_feature / lsgm embeddings", "slice 6 (the rest)")
    return cls(
        nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        attention=m.get("attention", True), dropout=m.dropout,
        image_size=d.image_size, num_channels=d.num_channels,
        conditional=m.conditional, skip_rescale=m.skip_rescale,
        embedding_type=m.embedding_type.lower(),
        fourier_scale=m.get("fourier_scale", 16.0),
        init_scale=m.init_scale, nonlinearity=m.nonlinearity,
        scale_by_sigma=m.scale_by_sigma, sigma_min=m.sigma_min,
        sigma_max=m.sigma_max, num_scales=m.num_scales, centered=d.centered)
