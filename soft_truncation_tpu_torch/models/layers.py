"""Shared building blocks of the score networks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/layers.py``. Tensors stay
channels-last at every module boundary, as in the JAX package; convolutions
view them as NCHW for ``F.conv2d``. Parameters keep PyTorch's layouts (conv
``[O, I, kh, kw]``, dense ``[out, in]``); ``utils/jax_params.py`` maps the
Flax tree onto them. Inits follow the JAX package's variance-scaling family,
drawn from an explicit ``torch.Generator`` by ``reset_parameters``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def get_act(nonlinearity: str) -> Callable[[torch.Tensor], torch.Tensor]:
  """Activation by config name."""
  name = nonlinearity.lower()
  if name == "elu":
    return F.elu
  if name == "relu":
    return F.relu
  if name == "lrelu":
    return lambda x: F.leaky_relu(x, negative_slope=0.2)
  if name == "swish":
    return F.silu
  raise NotImplementedError(f"activation {nonlinearity} does not exist")


def default_init(scale: float = 1.0):
  """DDPM initializer: variance_scaling(scale, fan_avg, uniform).

  Returns ``init(tensor, fan_in, fan_out, generator)``. scale == 0 is
  clamped to 1e-10, used for "zero-init" output layers.
  """
  scale = 1e-10 if scale == 0 else scale

  def init(tensor: torch.Tensor, fan_in: int, fan_out: int,
           generator: Optional[torch.Generator] = None) -> None:
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
      tensor.uniform_(-limit, limit, generator=generator)

  return init


class DDPMConv(nn.Module):
  """kxk stride-1 SAME conv on NHWC with DDPM init (zero bias)."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
               init_scale: float = 1.0):
    super().__init__()
    self.init_scale = init_scale
    self.weight = nn.Parameter(
        torch.empty(out_ch, in_ch, kernel_size, kernel_size))
    self.bias = nn.Parameter(torch.zeros(out_ch))
    self._hwio, self._hwio_key = None, None

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i, kh, kw = self.weight.shape
    default_init(self.init_scale)(self.weight, i * kh * kw, o * kh * kw,
                                  generator)
    with torch.no_grad():
      self.bias.zero_()

  def weight_hwio(self) -> torch.Tensor:
    """The kernel as ``[kh, kw, I, O]``, the fused kernel's layout.

    Transposed once per weight value (a load, an in-place update or a move
    to another device makes a new copy), not once per forward."""
    key = (self.weight.device, self.weight.data_ptr(), self.weight._version)
    if self._hwio_key != key:
      self._hwio = self.weight.detach().permute(2, 3, 1, 0).contiguous()
      self._hwio_key = key
    return self._hwio

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    pad = self.weight.shape[-1] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, padding=pad)
    return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
  """Dense layer over the last axis with DDPM init (zero bias)."""

  def __init__(self, in_features: int, out_features: int,
               init_scale: float = 1.0):
    super().__init__()
    self.init_scale = init_scale
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features))

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i = self.weight.shape
    default_init(self.init_scale)(self.weight, i, o, generator)
    with torch.no_grad():
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, self.weight, self.bias)


def NIN(in_ch: int, out_ch: int, init_scale: float = 0.1) -> Dense:
  """1x1 "network-in-network": a dense layer over the channel axis."""
  return Dense(in_ch, out_ch, init_scale=init_scale)


class GroupNorm(nn.Module):
  """GroupNorm over an NHWC tensor, as ``flax.linen.GroupNorm`` computes it.

  Statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, then
  ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""

  def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
    super().__init__()
    self.num_groups = num_groups
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self.weight.fill_(1.0)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    g = self.num_groups
    xg = x.float().reshape(n, h * w, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg.square().mean(dim=(1, 3), keepdim=True)
           - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
    y = (xg - mean) * mul + self.bias.reshape(g, c // g)
    return y.reshape(n, h, w, c).to(x.dtype)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
  """Sinusoidal transformer-style embedding of a [B] tensor."""
  if timesteps.dim() != 1:
    raise ValueError(f"timesteps must be 1-D, got {tuple(timesteps.shape)}")
  half_dim = embedding_dim // 2
  emb = math.log(max_positions) / (half_dim - 1)
  emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                               device=timesteps.device) * -emb)
  emb = timesteps.float()[:, None] * emb[None, :]
  emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
  if embedding_dim % 2 == 1:
    emb = F.pad(emb, (0, 1))
  return emb


def spatial_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
  """All-pairs spatial self-attention over an NHWC feature map.

  out[b,h,w,:] = sum_ij softmax_ij(q[b,h,w].k[b,i,j] / sqrt(C)) v[b,i,j],
  with the softmax in f32."""
  b, h, w, c = q.shape
  q = q.reshape(b, h * w, c)
  k = k.reshape(b, h * w, c)
  v = v.reshape(b, h * w, c)
  logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * (int(c) ** -0.5)
  weights = torch.softmax(logits, dim=-1)
  out = torch.bmm(weights.to(v.dtype), v)
  return out.reshape(b, h, w, c)
