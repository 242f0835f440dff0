"""The normalization zoo of the legacy networks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/normalization.py``, with its
torch semantics: instance norm over H, W with the biased variance and eps
1e-5; ``VarianceNorm2d`` and the conditional variance norm divide by the
UNBIASED spatial variance; InstanceNorm++ normalizes the per-channel means
across channels with their unbiased variance (``c / max(c - 1, 1)``);
affine scales start at N(1, 0.02) and biases at 0. The class-conditional
norms look up their per-class affine parameters in ``embed`` (a
``weight`` of one row per class, Flax's ``embed/embedding``).
``ConditionalBatchNorm2d`` keeps torch's ``BatchNorm2d(affine=False)``
running statistics in the buffers ``bn.running_mean`` / ``bn.running_var``
(the JAX package's ``batch_stats`` collection): momentum 0.1 and the
unbiased batch variance accumulated, the biased one normalizing in train
mode.

Each module takes its channel count first (Flax reads it off the input);
the conditional ones take the integer class labels ``y`` beside ``x``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import GroupNorm


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """Per-sample, per-channel normalization over H and W (no affine)."""
  mean = x.mean(dim=(1, 2), keepdim=True)
  var = x.var(dim=(1, 2), keepdim=True, correction=0)
  return (x - mean) / torch.sqrt(var + eps)


def _unbiased_spatial_var(x: torch.Tensor) -> torch.Tensor:
  n = x.shape[1] * x.shape[2]
  return x.var(dim=(1, 2), keepdim=True, correction=0) * n / max(n - 1, 1)


def _normalized_means(x: torch.Tensor) -> torch.Tensor:
  """InstanceNorm++'s re-injected term: the per-channel spatial means,
  normalized across channels by their unbiased variance; [B, C]."""
  c = x.shape[-1]
  means = x.mean(dim=(1, 2))
  m = means.mean(dim=-1, keepdim=True)
  v = means.var(dim=-1, keepdim=True, correction=0) * c / max(c - 1, 1)
  return (means - m) / torch.sqrt(v + 1e-5)


def _normal_(t: torch.Tensor, generator, mean=1.0, std=0.02):
  with torch.no_grad():
    t.normal_(mean, std, generator=generator)


class InstanceNorm2d(nn.Module):
  """``nn.InstanceNorm2d(affine=False)`` on NHWC."""

  def __init__(self, channels: int, bias: bool = True):
    super().__init__()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return instance_norm_2d(x)


class NoneNorm2d(nn.Module):

  def __init__(self, channels: int, bias: bool = True):
    super().__init__()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return x


class VarianceNorm2d(nn.Module):
  """x / sqrt(unbiased spatial var + 1e-5) * alpha."""

  def __init__(self, channels: int, bias: bool = False):
    super().__init__()
    self.alpha = nn.Parameter(torch.ones(channels))

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    _normal_(self.alpha, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.alpha * (x / torch.sqrt(_unbiased_spatial_var(x) + 1e-5))


class InstanceNorm2dPlus(nn.Module):
  """InstanceNorm++: instance norm plus the channel-normalized spatial
  means times ``alpha``, then ``gamma`` (and ``beta``)."""

  def __init__(self, channels: int, bias: bool = True):
    super().__init__()
    self.alpha = nn.Parameter(torch.ones(channels))
    self.gamma = nn.Parameter(torch.ones(channels))
    self.beta = nn.Parameter(torch.zeros(channels)) if bias else None

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    _normal_(self.alpha, generator)
    _normal_(self.gamma, generator)
    if self.beta is not None:
      with torch.no_grad():
        self.beta.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    means = _normalized_means(x)
    h = instance_norm_2d(x) + means[:, None, None, :] * self.alpha
    if self.beta is not None:
      return self.gamma * h + self.beta
    return self.gamma * h


class _ClassEmbed(nn.Module):
  """Per-class affine rows (Flax's ``nn.Embed``): ``weight`` [classes,
  width], row ``y`` for label ``y``; ``init(weight, generator)`` draws
  them."""

  def __init__(self, num_classes: int, width: int, init):
    super().__init__()
    self._init = init
    self.weight = nn.Parameter(torch.empty(num_classes, width))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self._init(self.weight, generator)

  def forward(self, y: torch.Tensor) -> torch.Tensor:
    return F.embedding(y, self.weight)


def _uniform_gamma_zero_beta(c: int):
  """Rows [gamma U[0, 1) | beta 0], as the JAX package's conditional norms
  draw them."""

  def init(weight, generator):
    weight[:, :c].uniform_(0.0, 1.0, generator=generator)
    weight[:, c:].zero_()

  return init


def _uniform(weight, generator):
  weight.uniform_(0.0, 1.0, generator=generator)


def _normal_rows(weight, generator):
  weight.normal_(1.0, 0.02, generator=generator)


def _split_rows(emb: torch.Tensor, parts: int):
  return [p[:, None, None, :] for p in emb.chunk(parts, dim=-1)]


class _ClassAffine(nn.Module):
  """``gamma * h + beta`` with per-class (gamma, beta) rows, or ``gamma *
  h`` alone without ``bias``: the affine of the conditional batch,
  instance and none norms."""

  def __init__(self, channels: int, num_classes: int, bias: bool):
    super().__init__()
    self.bias = bias
    if bias:
      self.embed = _ClassEmbed(num_classes, 2 * channels,
                               _uniform_gamma_zero_beta(channels))
    else:
      self.embed = _ClassEmbed(num_classes, channels, _uniform)

  def affine(self, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if self.bias:
      gamma, beta = _split_rows(self.embed(y), 2)
      return gamma * h + beta
    return self.embed(y)[:, None, None, :] * h


class _BatchNorm2dTorch(nn.Module):
  """``torch.nn.BatchNorm2d(affine=False)``'s running statistics on NHWC:
  at train the batch's biased variance normalizes and its unbiased one
  goes into ``running_var`` (momentum 0.1); at eval the running ones."""

  def __init__(self, channels: int, momentum: float = 0.1,
               eps: float = 1e-5):
    super().__init__()
    self.momentum, self.eps = momentum, eps
    self.register_buffer("running_mean", torch.zeros(channels))
    self.register_buffer("running_var", torch.ones(channels))

  def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
    if train:
      n = x.shape[0] * x.shape[1] * x.shape[2]
      mean = x.mean(dim=(0, 1, 2))
      var = x.var(dim=(0, 1, 2), correction=0)
      m = self.momentum
      with torch.no_grad():
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var * n / max(n - 1, 1))
    else:
      mean, var = self.running_mean, self.running_var
    return (x - mean) / torch.sqrt(var + self.eps)


class ConditionalBatchNorm2d(_ClassAffine):
  """Batch norm (:class:`_BatchNorm2dTorch`, under ``bn``) with a
  per-class affine. Unreachable from any config, in the JAX package as in
  its reference; ported for the zoo's completeness."""

  def __init__(self, channels: int, num_classes: int, bias: bool = True):
    super().__init__(channels, num_classes, bias)
    self.bn = _BatchNorm2dTorch(channels)

  def forward(self, x: torch.Tensor, y: torch.Tensor,
              train: bool = True) -> torch.Tensor:
    return self.affine(self.bn(x, train=train), y)


class ConditionalInstanceNorm2d(_ClassAffine):

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return self.affine(instance_norm_2d(x), y)


class ConditionalNoneNorm2d(_ClassAffine):
  """The per-class affine alone, no normalization."""

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return self.affine(x, y)


class ConditionalVarianceNorm2d(nn.Module):
  """x / sqrt(unbiased spatial var + 1e-5) times a per-class gamma drawn
  N(1, 0.02) (``bias`` is accepted and unused, as in the JAX package)."""

  def __init__(self, channels: int, num_classes: int, bias: bool = False):
    super().__init__()
    self.embed = _ClassEmbed(num_classes, channels, _normal_rows)

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = x / torch.sqrt(_unbiased_spatial_var(x) + 1e-5)
    return self.embed(y)[:, None, None, :] * h


class ConditionalInstanceNorm2dPlus(nn.Module):
  """Class-conditional InstanceNorm++: per-class (gamma, alpha, beta) rows,
  gamma and alpha drawn N(1, 0.02), beta 0; without ``bias`` (gamma,
  alpha)."""

  def __init__(self, channels: int, num_classes: int, bias: bool = True):
    super().__init__()
    self.bias = bias
    c = channels

    def init(weight, generator):
      weight[:, :2 * c].normal_(1.0, 0.02, generator=generator)
      weight[:, 2 * c:].zero_()

    self.embed = _ClassEmbed(num_classes, (3 if bias else 2) * c, init)

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    means = _normalized_means(x)[:, None, None, :]
    h = instance_norm_2d(x)
    if self.bias:
      gamma, alpha, beta = _split_rows(self.embed(y), 3)
      return gamma * (h + means * alpha) + beta
    gamma, alpha = _split_rows(self.embed(y), 2)
    return gamma * (h + means * alpha)


def get_normalization(config, conditional: bool = False):
  """The normalization class of ``config.model.normalization``, to be
  called with the channel count (the conditional ones bound to
  ``model.num_classes``)."""
  norm = config.model.normalization
  if conditional:
    if norm == "InstanceNorm++":
      return functools.partial(ConditionalInstanceNorm2dPlus,
                               num_classes=config.model.num_classes)
    raise NotImplementedError(f"{norm} not implemented yet.")
  if norm == "InstanceNorm":
    return InstanceNorm2d
  if norm == "InstanceNorm++":
    return InstanceNorm2dPlus
  if norm == "VarianceNorm":
    return VarianceNorm2d
  if norm == "GroupNorm":
    return functools.partial(GroupNorm, 32)
  raise ValueError(f"Unknown normalization: {norm}")
