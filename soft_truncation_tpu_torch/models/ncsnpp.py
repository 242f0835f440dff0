"""NCSN++ / DDPM++ / UNCSN++ U-Net (NHWC), in PyTorch: every option of the
JAX package's.

Counterpart of ``soft_truncation_tpu/models/ncsnpp.py``, with the same block
names as the Flax module (``temb_dense0/1``, ``stem``, ``down_{i}_{j}``,
``down_attn_{i}_{j}``, ``down_{i}_ds``, ``mid_res0``, ``mid_attn``,
``mid_res1``, ``up_{i}_{j}``, ``up_attn_{i}``, ``up_{i}_us``, ``out_norm``,
``out_conv``), so a Flax parameter tree maps onto the state_dict by path.

Options: positional (with ``lsgm``, of width ``embedding_dim``) and Fourier
time embeddings, ``conditional``, ``fourier_feature`` input features,
BigGAN or DDPM res-blocks (``resblock_type``) with ``auxiliary_resblock``,
FIR or nearest / mean-pool resampling (``fir``, ``resamp_with_conv``),
attention, the progressive input (``input_skip`` / ``residual``, combined
by ``sum`` or ``cat``) and output (``output_skip`` / ``residual``)
pyramids with or without FIR, ``skip_rescale``, ``centered`` and
``scale_by_sigma``, at eval and at train (``train=True``: dropout, whose
mask comes from the ``generator`` passed to the forward, and no fused
sites). As in JAX, without ``auxiliary_resblock`` a level's
downsampling result is never read (JAX's compiler drops it; the port does
not compute it), and attention follows each block's actual resolution.

``config.tpu.activation_dtype = 'float8_e4m3'`` (``act_quant``) makes the
convs JAX quantizes ``ops.quant.QConv`` (e4m3 input storage, e5m2
cotangents): the stem, every res-block's conv0, conv1 and conv shortcut,
the output pyramid's convs and ``out_conv``; not the resampling convs, the
combine conv or the NIN / Dense layers, and not the fused eval sites,
which run ``gn_silu_conv3x3`` unquantized as JAX's do.

``config.tpu.compute_dtype`` / ``norm_dtype`` ('float32' or 'bfloat16',
``configs/base.py::tpu_dtype``): every conv, NIN, Dense and conv-resample
computes in ``dtype`` (parameters stay f32 and are cast per call, or once
per eval function by ``models/score.py::cast_params_for_eval``), and the
fused sites run the kernels' matching mode; the res-blocks' and attention
blocks' GroupNorms give ``norm_dtype``, the heads' (``pyr_norm_*``,
``out_norm``) the promotion of their input with f32, as JAX's
``nn.GroupNorm`` without ``dtype=``. The time embeddings are f32, the input
and a residual input pyramid f32 (its conv-resamples compute in their
input's dtype), ``scale_by_sigma`` divides by f32 sigmas; the output's dtype
follows, as in JAX (bf16 for the flagship, f32 with ``scale_by_sigma``).

``config.tpu.remat`` checkpoints every res-block at train, as JAX's
``nn.remat`` wraps its block class: ``torch.utils.checkpoint`` without
re-entry keeps a block's input and recomputes the rest in the backward
(``remat_policy`` 'full'), or keeps the convolutions' outputs as well and
recomputes the norms, activations and dropout ('conv_outputs', JAX's
``save_only_these_names('conv_out')`` on the tagged ``DDPMConv`` outputs;
selective activation checkpointing). The recompute runs a block's FIR
resamples again, through the kernel. Dropout draws its masks from the
forward's explicit generator, which ``preserve_rng_state`` does not cover:
:func:`remat_block` rewinds it to its state at the block's entry for the
recompute and puts it back after, so the recomputed masks are the forward's
and the next draws do not repeat.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import tpu_dropout_bits, tpu_dtype
from . import layerspp
from .layers import (DDPMConv, Dense, GroupNorm, ddpm_conv, get_act,
                     get_timestep_embedding)
from .registry import register_model


REMAT_POLICIES = ("full", "conv_outputs")


def _save_conv_outputs(ctx, op, *args, **kwargs):
  """'conv_outputs': keep the convolutions' results, recompute the rest."""
  if op is torch.ops.aten.convolution.default:
    return CheckpointPolicy.MUST_SAVE
  return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(block: nn.Module, x: torch.Tensor,
                temb: Optional[torch.Tensor],
                generator: Optional[torch.Generator],
                policy: str = "full") -> torch.Tensor:
  """``block(x, temb, True, generator)`` under activation checkpointing,
  its recompute drawing the forward's dropout masks again (module
  docstring)."""
  entry = None if generator is None else generator.get_state()
  runs = []

  def run(x, temb):
    runs.append(None)
    if len(runs) == 1 or generator is None:
      return block(x, temb, True, generator)
    after = generator.get_state()
    generator.set_state(entry)
    try:
      return block(x, temb, True, generator)
    finally:
      generator.set_state(after)

  kwargs = {}
  if policy == "conv_outputs":
    kwargs["context_fn"] = functools.partial(
        create_selective_checkpoint_contexts, _save_conv_outputs)
  return checkpoint(run, x, temb, use_reentrant=False, **kwargs)


def get_sigmas(sigma_min: float, sigma_max: float,
               num_scales: int) -> np.ndarray:
  """Descending geometric noise grid."""
  return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
  """Config-driven NCSN++ family U-Net."""

  def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
               num_res_blocks: int = 4,
               attn_resolutions: Sequence[int] = (16,),
               attention: bool = True, dropout: float = 0.1,
               resamp_with_conv: bool = True,
               image_size: int = 32, num_channels: int = 3,
               conditional: bool = True, fir: bool = False,
               fir_kernel: Sequence[float] = (1, 3, 3, 1),
               skip_rescale: bool = True, resblock_type: str = "biggan",
               auxiliary_resblock: bool = True, progressive: str = "none",
               progressive_input: str = "none",
               progressive_combine: str = "sum",
               embedding_type: str = "fourier", fourier_scale: float = 16.0,
               fourier_feature: bool = False,
               init_scale: float = 0.0, nonlinearity: str = "swish",
               scale_by_sigma: bool = False, lsgm: bool = False,
               embedding_dim: int = 128, sigma_min: float = 0.01,
               sigma_max: float = 50.0, num_scales: int = 1000,
               centered: bool = True, act_quant: Optional[str] = None,
               remat: bool = False, remat_policy: str = "full",
               dropout_bits: int = 32, dtype: torch.dtype = torch.float32,
               norm_dtype: torch.dtype = torch.float32):
    super().__init__()
    if remat_policy not in REMAT_POLICIES:
      raise ValueError(f"unknown remat_policy {remat_policy!r}")
    self.remat, self.remat_policy = remat, remat_policy
    if embedding_type not in ("fourier", "positional"):
      raise ValueError(f"unknown embedding_type {embedding_type!r}")
    if progressive not in ("none", "output_skip", "residual"):
      raise ValueError(f"unknown progressive {progressive!r}")
    if progressive_input not in ("none", "input_skip", "residual"):
      raise ValueError(f"unknown progressive_input {progressive_input!r}")
    if resblock_type not in ("biggan", "ddpm"):
      raise ValueError(f"unknown resblock_type {resblock_type!r}")
    act = get_act(nonlinearity)
    self.embedding_type = embedding_type
    self.conditional = conditional
    self.centered = centered
    self.scale_by_sigma = scale_by_sigma
    self.fourier_feature = fourier_feature
    self.sigmas = (sigma_min, sigma_max, num_scales)
    self.act = act
    self.num_resolutions = len(ch_mult)
    self.num_res_blocks = num_res_blocks
    self.skip_rescale = skip_rescale
    self.ddpm_blocks = resblock_type == "ddpm"
    self.auxiliary_resblock = auxiliary_resblock
    self.progressive = progressive
    self.progressive_input = progressive_input

    # the time embedding: Fourier features of width 2 nf, or sinusoids of
    # width nf (embedding_dim with lsgm), then two Dense of 4x that width
    if embedding_type == "fourier":
      self.fourier_emb = layerspp.GaussianFourierProjection(
          embedding_size=nf, scale=fourier_scale)
      embed_dim, temb_dim = 2 * nf, 4 * nf
    else:
      self.embed_dim = embedding_dim if lsgm else nf
      embed_dim = temb_dim = self.embed_dim
      temb_dim *= 4
    if not conditional:
      temb_dim = None
    else:
      self.temb_dense0 = Dense(embed_dim, temb_dim)
      self.temb_dense1 = Dense(temb_dim, temb_dim)

    def res_block(in_ch, out_ch=None, up=False, down=False):
      if self.ddpm_blocks:
        return layerspp.ResnetBlockDDPMpp(
            act, in_ch, out_ch, temb_dim=temb_dim, dropout=dropout,
            skip_rescale=skip_rescale, init_scale=init_scale,
            act_quant=act_quant, dropout_bits=dropout_bits)
      return layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, temb_dim=temb_dim, up=up, down=down,
          dropout=dropout, fir=fir, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale,
          act_quant=act_quant, dropout_bits=dropout_bits)

    def attn_block(ch):
      return layerspp.AttnBlockpp(ch, skip_rescale=skip_rescale,
                                  init_scale=init_scale)

    def resample(mode, in_ch, out_ch=None, with_conv=False):
      return layerspp.Resample(mode, in_ch, out_ch, with_conv=with_conv,
                               fir_kernel=fir_kernel, fir=fir)

    # channel and resolution bookkeeping mirrors the Flax module's dataflow
    self.stem = ddpm_conv(num_channels * (5 if fourier_feature else 1), nf, 3,
                          act_quant=act_quant)
    hs = [(nf, image_size)]  # (channels, resolution) of each skip
    ch, res = nf, image_size
    pyr_ch = num_channels  # channels of the input pyramid
    self._attn_down, self._attn_up = set(), set()
    for i in range(self.num_resolutions):
      for j in range(num_res_blocks):
        ch, res = hs[-1]
        out = nf * ch_mult[i]
        self.add_module(f"down_{i}_{j}", res_block(ch, out))
        ch = out
        if res in attn_resolutions and attention:
          self.add_module(f"down_attn_{i}_{j}", attn_block(ch))
          self._attn_down.add((i, j))
        hs.append((ch, res))
      if i != self.num_resolutions - 1:
        ch, res = hs[-1]
        if self.ddpm_blocks:
          self.add_module(f"down_{i}_ds", resample(
              "down", ch, with_conv=resamp_with_conv))
          res //= 2
        elif auxiliary_resblock:
          self.add_module(f"down_{i}_ds", res_block(ch, down=True))
          res //= 2
        if progressive_input == "input_skip":
          self.add_module(f"pyr_ds_{i}", resample("down", num_channels))
          self.add_module(f"combine_{i}", layerspp.Combine(
              num_channels, ch, method=progressive_combine))
          if progressive_combine == "cat":
            ch *= 2
        elif progressive_input == "residual":
          self.add_module(f"pyr_ds_{i}", resample("down", pyr_ch, ch,
                                                  with_conv=True))
          pyr_ch = ch
        if auxiliary_resblock:
          hs.append((ch, res))

    ch, res = hs[-1]
    if not auxiliary_resblock:
      hs.pop()
    self.mid_res0 = res_block(ch)
    self.mid_attn = attn_block(ch)
    self.mid_res1 = res_block(ch)

    self.num_res_up = num_res_blocks + (1 if auxiliary_resblock else 0)
    for i in reversed(range(self.num_resolutions)):
      for j in range(self.num_res_up):
        out = nf * ch_mult[i]
        self.add_module(f"up_{i}_{j}", res_block(ch + hs.pop()[0], out))
        ch = out
      if res in attn_resolutions and attention:
        self.add_module(f"up_attn_{i}", attn_block(ch))
        self._attn_up.add(i)
      if progressive != "none":
        if i == self.num_resolutions - 1:
          out = num_channels if progressive == "output_skip" else ch
          self.add_module(f"pyr_norm_{i}", GroupNorm(min(ch // 4, 32), ch))
          self.add_module(f"pyr_conv_{i}", ddpm_conv(
              ch, out, 3,
              init_scale=init_scale if progressive == "output_skip" else 1.0,
              act_quant=act_quant))
          pyr_ch = out
        elif progressive == "output_skip":
          self.add_module(f"pyr_us_{i}", resample("up", num_channels))
          self.add_module(f"pyr_norm_{i}", GroupNorm(min(ch // 4, 32), ch))
          self.add_module(f"pyr_conv_{i}", ddpm_conv(
              ch, num_channels, 3, init_scale=init_scale,
              act_quant=act_quant))
        else:
          self.add_module(f"pyr_us_{i}", resample("up", pyr_ch, ch,
                                                  with_conv=True))
          pyr_ch = ch
      if i != 0:
        if self.ddpm_blocks:
          self.add_module(f"up_{i}_us", resample(
              "up", ch, with_conv=resamp_with_conv))
          res *= 2
        elif auxiliary_resblock:
          self.add_module(f"up_{i}_us", res_block(ch, up=True))
          res *= 2
    assert not hs

    if progressive != "output_skip":
      self.out_norm = GroupNorm(min(ch // 4, 32), ch)
      self.out_conv = ddpm_conv(ch, num_channels, 3, init_scale=init_scale,
                                act_quant=act_quant)
    self._set_dtypes(dtype, norm_dtype)

  def _set_dtypes(self, dtype: torch.dtype, norm_dtype: torch.dtype) -> None:
    """Each conv, NIN, Dense and conv-resample computes in ``dtype``; the
    blocks' GroupNorms give ``norm_dtype``, the heads' keep None (module
    docstring)."""
    self.dtype, self.norm_dtype = dtype, norm_dtype
    for name, m in self.named_modules():
      if isinstance(m, (DDPMConv, Dense, layerspp.ConvResample)):
        m.dtype = dtype
      elif isinstance(m, GroupNorm) and not name.startswith(
          ("pyr_norm_", "out_norm")):
        m.dtype = norm_dtype

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every parameter from ``generator`` in module order."""
    for m in self.modules():
      if m is not self and hasattr(m, "reset_parameters"):
        m.reset_parameters(generator)

  def fused_sites(self) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, O) of each fused norm->SiLU->conv call of the last forward."""
    return [s for m in self.modules()
            for s in getattr(m, "last_fused_sites", ())]

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
      temb = get_timestep_embedding(time_cond, self.embed_dim)

    if self.conditional:
      temb = self.temb_dense1(act(self.temb_dense0(temb)))
    else:
      temb = None

    if not self.centered:
      x = 2 * x - 1.0

    input_pyramid = x if self.progressive_input != "none" else None
    if self.fourier_feature:
      x = layerspp.fixed_fourier_features(x)
    hs = [self.stem(x)]
    for i in range(self.num_resolutions):
      for j in range(self.num_res_blocks):
        h = self._res(f"down_{i}_{j}", hs[-1], temb, train, generator)
        if (i, j) in self._attn_down:
          h = getattr(self, f"down_attn_{i}_{j}")(h)
        hs.append(h)
      # without auxiliary res-blocks nothing below is read
      if i != self.num_resolutions - 1 and self.auxiliary_resblock:
        if self.ddpm_blocks:
          h = getattr(self, f"down_{i}_ds")(hs[-1])
        else:
          h = self._res(f"down_{i}_ds", hs[-1], temb, train, generator)
        if self.progressive_input == "input_skip":
          input_pyramid = getattr(self, f"pyr_ds_{i}")(input_pyramid)
          h = getattr(self, f"combine_{i}")(input_pyramid, h)
        elif self.progressive_input == "residual":
          input_pyramid = self._merge(getattr(self, f"pyr_ds_{i}")(
              input_pyramid), h)
          h = input_pyramid
        hs.append(h)

    h = hs[-1]
    if not self.auxiliary_resblock:
      hs.pop()
    h = self._res("mid_res0", h, temb, train, generator)
    h = self.mid_attn(h)
    h = self._res("mid_res1", h, temb, train, generator)

    for i in reversed(range(self.num_resolutions)):
      for j in range(self.num_res_up):
        h = self._res(f"up_{i}_{j}", torch.cat([h, hs.pop()], dim=-1),
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
      if i != 0 and self.ddpm_blocks:
        h = getattr(self, f"up_{i}_us")(h)
      elif i != 0 and self.auxiliary_resblock:
        h = self._res(f"up_{i}_us", h, temb, train, generator)

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

  def _res(self, name: str, h: torch.Tensor, temb: Optional[torch.Tensor],
           train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The res-block ``name``; checkpointed at train with ``remat`` when
    gradients are taken."""
    block = getattr(self, name)
    if self.remat and train and torch.is_grad_enabled():
      return remat_block(block, h, temb, generator, self.remat_policy)
    return block(h, temb, train, generator)

  def _merge(self, pyramid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A residual pyramid step: the sum, rescaled with ``skip_rescale``."""
    if self.skip_rescale:
      return (pyramid + h) / math.sqrt(2.0)
    return pyramid + h

  @classmethod
  def from_config(cls, config) -> "NCSNpp":
    """Build from a config with the JAX package's schema."""
    m, d = config.model, config.data
    return cls(
        nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        attention=m.get("attention", True), dropout=m.dropout,
        resamp_with_conv=m.get("resamp_with_conv", True),
        image_size=d.image_size, num_channels=d.num_channels,
        conditional=m.conditional, fir=m.fir,
        fir_kernel=tuple(m.fir_kernel), skip_rescale=m.skip_rescale,
        resblock_type=m.resblock_type.lower(),
        auxiliary_resblock=m.get("auxiliary_resblock", True),
        progressive=m.progressive.lower(),
        progressive_input=m.progressive_input.lower(),
        progressive_combine=m.progressive_combine.lower(),
        embedding_type=m.embedding_type.lower(),
        fourier_scale=m.get("fourier_scale", 16.0),
        fourier_feature=m.get("fourier_feature", False),
        init_scale=m.init_scale, nonlinearity=m.nonlinearity,
        scale_by_sigma=m.scale_by_sigma, lsgm=m.get("lsgm", False),
        embedding_dim=m.get("embedding_dim", 128), sigma_min=m.sigma_min,
        sigma_max=m.sigma_max, num_scales=m.num_scales, centered=d.centered,
        act_quant=config.get("tpu", {}).get("activation_dtype", "") or None,
        remat=config.get("tpu", {}).get("remat", False),
        remat_policy=config.get("tpu", {}).get("remat_policy", "full"),
        dropout_bits=tpu_dropout_bits(config),
        dtype=getattr(torch, tpu_dtype(config, "compute_dtype")),
        norm_dtype=getattr(torch, tpu_dtype(config, "norm_dtype")))
