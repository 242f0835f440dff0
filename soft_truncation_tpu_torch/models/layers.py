"""Shared building blocks of the score networks (NHWC), in PyTorch.

Counterpart of ``soft_truncation_tpu/models/layers.py``: the NCSN++ blocks'
parts and the legacy networks' blocks (``NCSNConv`` with its init,
``AttnBlock``, ``ResnetBlockDDPM``; its ``Upsample`` / ``Downsample`` are
``layerspp.Resample`` without FIR, which computes the same). Tensors stay
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

from ..ops._autodiff import below_transforms
from ..ops._build import tracing
from ..ops.gn_conv import weight_operand
from .dropout import Dropout


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
  """kxk SAME conv on NHWC with DDPM init (zero bias); with ``stride=2``
  the JAX package's strided downsampling conv instead, padded by one row
  and column at the bottom and right only."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
               init_scale: float = 1.0, stride: int = 1):
    super().__init__()
    if stride not in (1, 2):
      raise ValueError(f"stride must be 1 or 2, got {stride}")
    self.init_scale = init_scale
    self.stride = stride
    self.weight = nn.Parameter(
        torch.empty(out_ch, in_ch, kernel_size, kernel_size))
    self.bias = nn.Parameter(torch.zeros(out_ch))
    self._derived, self._derived_key = {}, None
    self.traced_operands = None
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i, kh, kw = self.weight.shape
    default_init(self.init_scale)(self.weight, i * kh * kw, o * kh * kw,
                                  generator)
    with torch.no_grad():
      self.bias.zero_()

  def _once_per_weight(self, name: str, make):
    """``make()`` once per weight value (a load, an in-place update or a
    move to another device makes a new one), not once per forward. It runs
    below any ``torch.func`` transform, so that a first forward under
    ``torch.func.jvp`` caches plain tensors, which a kernel can read.

    While tracing (``torch.export``) nothing is cached and no data pointer
    is read: the value is ``traced_operands[name]`` where the exporter set
    it (an input of the exported program, prepared once per params load:
    ``serve/export.py``), else ``make()`` in the graph."""
    if tracing():
      if self.traced_operands is not None and name in self.traced_operands:
        return self.traced_operands[name]
      return make()
    key = (self.weight.device, self.weight.data_ptr(), self.weight._version)
    if self._derived_key != key:
      self._derived, self._derived_key = {}, key
    if name not in self._derived:
      with below_transforms():
        self._derived[name] = make()
    return self._derived[name]

  def weight_hwio(self) -> torch.Tensor:
    """The kernel as ``[kh, kw, I, O]``, the fused kernel's layout."""
    return self._once_per_weight(
        "hwio", lambda: self.weight.detach().permute(2, 3, 1, 0).contiguous())

  def weight_tf32_split(self):
    """The fused kernel's weight operand, ``ops.gn_conv.weight_operand`` of
    :meth:`weight_hwio`: padded and split into TF32 hi and lo."""
    return self._once_per_weight(
        "tf32_split", lambda: weight_operand(self.weight_hwio()))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    if self.stride == 2:
      y = F.conv2d(F.pad(x, (0, 1, 0, 1)), self.weight, self.bias, stride=2)
    else:
      y = F.conv2d(x, self.weight, self.bias,
                   padding=self.weight.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def ddpm_conv(in_ch: int, out_ch: int, kernel_size: int = 3,
              init_scale: float = 1.0, stride: int = 1,
              act_quant: Optional[str] = None) -> DDPMConv:
  """The JAX package's ``DDPMConv`` factory: a :class:`DDPMConv`, or with
  ``act_quant`` (``config.tpu.activation_dtype``, e.g. 'float8_e4m3') the
  drop-in ``ops.quant.QConv`` with the same parameters, which stores its
  input as e4m3. Any other value raises."""
  if not act_quant:
    return DDPMConv(in_ch, out_ch, kernel_size, init_scale, stride)
  from ..ops.quant import QConv
  return QConv(in_ch, out_ch, kernel_size, init_scale, stride, act_quant)


def ncsn_init(scale: float = 1.0):
  """NCSNv1/v2 init: torch's default conv init times ``scale``, i.e.
  U(-scale / sqrt(fan_in), scale / sqrt(fan_in)) for the kernel and (the
  JAX package's choice) the same bound for the bias. Returns
  ``init(tensor, fan_in, generator)``; scale == 0 is clamped to 1e-10."""
  scale = 1e-10 if scale == 0 else scale

  def init(tensor: torch.Tensor, fan_in: int,
           generator: Optional[torch.Generator] = None) -> None:
    bound = scale / math.sqrt(fan_in)
    with torch.no_grad():
      tensor.uniform_(-bound, bound, generator=generator)

  return init


class Conv2d(nn.Module):
  """A stride-1 conv on NHWC with 'SAME' padding (XLA's split: the odd
  extra row or column at the end) and ``dilation``; ``weight`` OIHW and an
  optional ``bias``. The Flax ``nn.Conv`` the legacy networks wrap; its
  init is the NCSN one (:func:`ncsn_init`) unless ``lecun`` (Flax's
  default, LeCun normal truncated at 2 std, zero bias)."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
               use_bias: bool = True, dilation: int = 1,
               init_scale: float = 1.0, lecun: bool = False):
    super().__init__()
    self.dilation, self.init_scale, self.lecun = dilation, init_scale, lecun
    self.weight = nn.Parameter(
        torch.empty(out_ch, in_ch, kernel_size, kernel_size))
    self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
    total = dilation * (kernel_size - 1)
    self.pads = (total // 2, total - total // 2) * 2
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i, kh, kw = self.weight.shape
    fan_in = i * kh * kw
    if self.lecun:
      std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
      with torch.no_grad():
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
          self.bias.zero_()
      return
    init = ncsn_init(self.init_scale)
    init(self.weight, fan_in, generator)
    if self.bias is not None:
      init(self.bias, fan_in, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = F.pad(x.permute(0, 3, 1, 2), self.pads)
    y = F.conv2d(x, self.weight, self.bias, dilation=self.dilation)
    return y.permute(0, 2, 3, 1)


class NCSNConv(nn.Module):
  """Conv with the NCSNv1/v2 init; its parameters sit under ``Conv_0`` as
  the Flax module's anonymous ``nn.Conv`` puts them. ``bias=False`` convs
  have no bias to scale, and a dilated conv pads 'SAME' (the intent fixes
  of ``PARITY.md`` #11-12, as in the JAX package)."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
               use_bias: bool = True, dilation: int = 1,
               init_scale: float = 1.0):
    super().__init__()
    self.Conv_0 = Conv2d(in_ch, out_ch, kernel_size, use_bias, dilation,
                         init_scale)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.Conv_0(x)


class Dense(nn.Module):
  """Dense layer over the last axis with DDPM init (zero bias)."""

  def __init__(self, in_features: int, out_features: int,
               init_scale: float = 1.0):
    super().__init__()
    self.init_scale = init_scale
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features))
    self.reset_parameters()

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


class AttnBlock(nn.Module):
  """The legacy DDPM attention block: GroupNorm(32), q / k / v / out NIN,
  a residual without rescale."""

  def __init__(self, channels: int):
    super().__init__()
    self.norm = GroupNorm(32, channels)
    self.q = NIN(channels, channels)
    self.k = NIN(channels, channels)
    self.v = NIN(channels, channels)
    self.out = NIN(channels, channels, init_scale=0.0)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = self.norm(x)
    h = spatial_attention(self.q(h), self.k(h), self.v(h))
    return x + self.out(h)


class ResnetBlockDDPM(nn.Module):
  """The legacy DDPM residual block: GroupNorm with 32 groups (whatever the
  width), act, conv, the time embedding's projection, GroupNorm, act,
  dropout (its mask from the forward's ``generator``), a zero-init conv,
  and a NIN (or with ``conv_shortcut`` a 3x3 conv) shortcut when the width
  changes. JAX runs it unfused, and so does the port."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, conv_shortcut: bool = False,
               dropout: float = 0.1):
    super().__init__()
    out_ch = out_ch or in_ch
    self.act = act
    self.norm0 = GroupNorm(32, in_ch)
    self.conv0 = DDPMConv(in_ch, out_ch, 3)
    self.temb_proj = (Dense(temb_dim, out_ch) if temb_dim is not None
                      else None)
    self.norm1 = GroupNorm(32, out_ch)
    self.dropout = Dropout(dropout)
    self.conv1 = DDPMConv(out_ch, out_ch, 3, init_scale=0.0)
    if in_ch == out_ch:
      self.shortcut = None
    elif conv_shortcut:
      self.shortcut = DDPMConv(in_ch, out_ch, 3)
    else:
      self.shortcut = NIN(in_ch, out_ch)

  def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    h = self.conv0(self.act(self.norm0(x)))
    if temb is not None:
      h = h + self.temb_proj(self.act(temb))[:, None, None, :]
    h = self.act(self.norm1(h))
    h = self.dropout(h, train, generator)
    h = self.conv1(h)
    if self.shortcut is not None:
      x = self.shortcut(x)
    return x + h
