"""The legacy NCSNv1 / NCSNv2 RefineNet networks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/ncsnv2.py``, registered under
the same names: ``ncsnv2_64`` (images under 96 px), ``ncsn`` (the
class-conditional NCSNv1 with conditional InstanceNorm++, ``PARITY.md``
#10), ``ncsnv2_128`` (96-128 px) and ``ncsnv2_256`` (129-256 px). The v2
networks divide their output by the noise level of each integer label,
``get_sigmas(...)[y]`` (``scale_by_sigma``); ``ncsn`` does not. Module
names are the Flax ones (``begin_conv``, ``res{k}_{i}``, ``refine{k}``,
``normalizer``, ``end_conv``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn

from .layers import NCSNConv, get_act
from .ncsnpp import get_sigmas
from .normalization import ConditionalInstanceNorm2dPlus, InstanceNorm2dPlus
from .refine import (CondRefineBlock, ConditionalResidualBlock, RefineBlock,
                     ResidualBlock)
from .registry import register_model


def _channels(data) -> int:
  return data.get("channels", data.get("num_channels", 3))


class _RefineNet(nn.Module):
  """The body the legacy networks share: ``begin_conv``, two residual
  blocks per level, the refine blocks from the deepest level up,
  ``normalizer``, act and ``end_conv``. ``levels``: (name, width
  multiplier, resample, dilation) per level; ``refines``: (name, width
  multiplier) per refine block; at 28 px the first block of ``adjust_at``
  pads its mean-pools. With ``conditional`` every norm and block takes the
  labels ``y``."""

  levels = (("res1", 1, None, 1), ("res2", 2, "down", 1),
            ("res3", 2, "down", 2), ("res4", 2, "down", 4))
  refines = (("refine1", 2), ("refine2", 2), ("refine3", 1), ("refine4", 1))
  adjust_at = "res4"

  def __init__(self, nf: int, image_size: int, num_channels: int,
               nonlinearity: str, centered: bool, norm, conditional: bool):
    super().__init__()
    self.act = act = get_act(nonlinearity)
    self.centered, self.conditional = centered, conditional
    block = ConditionalResidualBlock if conditional else ResidualBlock
    self.begin_conv = NCSNConv(num_channels, nf, 3)
    ch, chs = nf, []
    for name, mult, resample, dilation in self.levels:
      for i in range(2):
        adjust = i == 0 and name == self.adjust_at and image_size == 28
        self.add_module(f"{name}_{i}", block(
            ch, mult * nf, act, norm, resample=resample if i == 0 else None,
            adjust_padding=adjust, dilation=dilation))
        ch = mult * nf
      chs.append(ch)
    chs, prev = chs[::-1], None
    for k, (name, mult) in enumerate(self.refines):
      in_chs = [chs[k]] + ([prev] if prev is not None else [])
      end = k == len(self.refines) - 1
      self.add_module(name, CondRefineBlock(in_chs, mult * nf, norm, act,
                                            end=end) if conditional else
                      RefineBlock(in_chs, mult * nf, act, end=end))
      prev = mult * nf
    self.normalizer = norm(prev)
    self.end_conv = NCSNConv(prev, num_channels, 3)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every parameter from ``generator`` in module order."""
    for m in self.modules():
      if m is not self and hasattr(m, "reset_parameters"):
        m.reset_parameters(generator)

  def body(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    cond = (y,) if self.conditional else ()
    h = x if self.centered else 2 * x - 1.0
    h = self.begin_conv(h)
    skips = []
    for name, *_ in self.levels:
      h = getattr(self, f"{name}_0")(h, *cond)
      h = getattr(self, f"{name}_1")(h, *cond)
      skips.append(h)
    out = None
    for (name, _), skip in zip(self.refines, skips[::-1]):
      xs = [skip] + ([out] if out is not None else [])
      out = getattr(self, name)(xs, *cond, tuple(skip.shape[1:3]))
    return self.end_conv(self.act(self.normalizer(out, *cond)))


class _NCSNv2Base(_RefineNet):
  """The unconditional v2 networks, InstanceNorm++ throughout, the output
  divided by the noise level of each label."""

  def __init__(self, nf: int = 128, image_size: int = 32,
               num_channels: int = 3, nonlinearity: str = "elu",
               normalization: str = "InstanceNorm++",
               sigma_min: float = 0.01, sigma_max: float = 50.0,
               num_scales: int = 1000, centered: bool = False):
    if normalization != "InstanceNorm++":
      raise NotImplementedError(normalization)
    super().__init__(nf, image_size, num_channels, nonlinearity, centered,
                     InstanceNorm2dPlus, conditional=False)
    self.sigmas = (sigma_min, sigma_max, num_scales)

  def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    out = self.body(x, y)
    sigmas = torch.as_tensor(get_sigmas(*self.sigmas), dtype=torch.float32,
                             device=out.device)
    # clamped like the JAX package's gather
    used = sigmas[y.long().clamp(0, sigmas.shape[0] - 1)]
    return out / used.reshape((x.shape[0],) + (1,) * (out.dim() - 1))

  @classmethod
  def from_config(cls, config):
    m, d = config.model, config.data
    return cls(nf=m.nf, image_size=d.image_size, num_channels=_channels(d),
               nonlinearity=m.nonlinearity, normalization=m.normalization,
               sigma_min=m.sigma_min, sigma_max=m.sigma_max,
               num_scales=m.num_scales, centered=d.centered)


@register_model(name="ncsnv2_64")
class NCSNv2(_NCSNv2Base):
  """NCSNv2 for images under 96 px."""


@register_model(name="ncsnv2_128")
class NCSNv2_128(_NCSNv2Base):
  """NCSNv2 for 96-128 px images."""

  levels = (("res1", 1, None, 1), ("res2", 2, "down", 1),
            ("res3", 2, "down", 1), ("res4", 4, "down", 2),
            ("res5", 4, "down", 4))
  refines = (("refine1", 4), ("refine2", 2), ("refine3", 2), ("refine4", 1),
             ("refine5", 1))
  adjust_at = None


@register_model(name="ncsnv2_256")
class NCSNv2_256(_NCSNv2Base):
  """NCSNv2 for 129-256 px images."""

  levels = (("res1", 1, None, 1), ("res2", 2, "down", 1),
            ("res3", 2, "down", 1), ("res31", 2, "down", 1),
            ("res4", 4, "down", 2), ("res5", 4, "down", 4))
  refines = (("refine1", 4), ("refine2", 2), ("refine31", 2),
             ("refine3", 2), ("refine4", 1), ("refine5", 1))
  adjust_at = None


@register_model(name="ncsn")
class NCSN(_RefineNet):
  """The class-conditional NCSNv1: ``ncsnv2_64``'s layout with every norm a
  conditional InstanceNorm++ over ``num_scales`` classes, the labels ``y``
  the noise levels' indices, and no output scaling."""

  def __init__(self, nf: int = 128, image_size: int = 32,
               num_channels: int = 3, nonlinearity: str = "elu",
               num_scales: int = 1000, centered: bool = False):
    super().__init__(nf, image_size, num_channels, nonlinearity, centered,
                     functools.partial(ConditionalInstanceNorm2dPlus,
                                       num_classes=num_scales),
                     conditional=True)

  def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return self.body(x, y.long())

  @classmethod
  def from_config(cls, config):
    m, d = config.model, config.data
    return cls(nf=m.nf, image_size=d.image_size, num_channels=_channels(d),
               nonlinearity=m.nonlinearity, num_scales=m.num_scales,
               centered=d.centered)


def get_network(config) -> nn.Module:
  """The v2 network for ``config.data.image_size``."""
  size = config.data.image_size
  if size < 96:
    return NCSNv2.from_config(config)
  if 96 <= size <= 128:
    return NCSNv2_128.from_config(config)
  if 128 < size <= 256:
    return NCSNv2_256.from_config(config)
  raise NotImplementedError(
      f"No network suitable for {size}px implemented yet.")
