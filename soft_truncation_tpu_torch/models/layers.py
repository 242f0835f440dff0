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

Compute dtype (``config.tpu.compute_dtype``, the NCSN++ family only, set
on its modules by ``models/ncsnpp.py``): ``DDPMConv`` and ``Dense`` carry a
``dtype`` (f32 by default) and cast their input, weight and bias to it per
call, as Flax's ``dtype=`` does, the parameters staying f32;
``GroupNorm`` computes its statistics and affine in f32 and casts its
output once to its ``dtype`` (None: the promotion of the input's dtype
with f32, Flax's inference from the f32 parameters); attention's products
read bf16 values into f32 sums, its softmax is f32 and its weights are
cast to v's dtype (``soft_truncation_tpu/models/layers.py:190-198``).

Under a space axis (``parallel/spatial.py``: each rank holds H/s rows of
every image) a kxk conv takes k // 2 halo rows on each side (the stride-2
conv one row from below), GroupNorm sums its statistics over the axis, and
attention takes its keys and values from every rank's rows; ``Conv2d`` (the
legacy networks') refuses the axis.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops._autodiff import below_transforms
from ..ops._build import tracing
from ..ops.gn_conv import jvp_weight_operand, weight_operand
from ..parallel import spatial
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
    self.dtype = torch.float32  # the compute dtype (module docstring)
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
    """``make()`` once per weight value (a load, an in-place update, a move
    to another device or another tensor put in its place, as
    ``models/score.py::cast_params_for_eval``'s call does, makes a new
    one), not once per forward. The cache holds the weight it was made
    from, so its memory is not reused while the key stands. It runs
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
    w = self.weight
    # an inference tensor (a cast made under inference_mode) has no version
    # counter; it is not updated in place outside inference_mode
    version = -1 if w.is_inference() else w._version
    if (self._derived_key is None or self._derived_key[0] is not w
        or self._derived_key[1] != version):
      self._derived, self._derived_key = {}, (w, version)
    if name not in self._derived:
      with below_transforms():
        self._derived[name] = make()
    return self._derived[name]

  def weight_hwio(self) -> torch.Tensor:
    """The kernel as ``[kh, kw, I, O]`` in the compute dtype, the fused
    kernel's layout."""
    return self._once_per_weight(
        "hwio", lambda: self.weight.detach().to(self.dtype).permute(
            2, 3, 1, 0).contiguous())

  def weight_operand(self):
    """The fused kernel's weight operand, ``ops.gn_conv.weight_operand`` of
    :meth:`weight_hwio`: padded, and split into TF32 hi and lo in f32 (one
    transposed bf16 tensor in bf16)."""
    return self._once_per_weight(
        "operand", lambda: weight_operand(self.weight_hwio()))

  def jvp_weight_operand(self):
    """The fused kernel's tangent's weight operand, ``ops.gn_conv.
    jvp_weight_operand`` of :meth:`weight_hwio`: in f32 padded, transposed
    to output-channel rows and split into TF32 hi and lo; in bf16 the
    primal's, :meth:`weight_operand`."""
    if self.dtype == torch.bfloat16:
      return self.weight_operand()
    return self._once_per_weight(
        "jvp_operand", lambda: jvp_weight_operand(self.weight_hwio()))

  def compute_params(self):
    """The weight and bias in the compute dtype (the same tensors when
    they are in it already)."""
    return self.weight.to(self.dtype), self.bias.to(self.dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    space = spatial.current()
    if space is not None:
      return self._sharded(x, space)
    w, b = self.compute_params()
    x = x.to(self.dtype).permute(0, 3, 1, 2)
    if self.stride == 2:
      y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=2)
    else:
      y = F.conv2d(x, w, b, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)

  def _sharded(self, x: torch.Tensor, space) -> torch.Tensor:
    """The conv of this rank's rows: the rows padding would add come from
    the neighbours (zeros past the image's edges)."""
    w, b = self.compute_params()
    x = x.to(self.dtype)
    if self.stride == 2:
      if x.shape[1] % 2:  # an even first row, as in the whole image
        raise ValueError(f"a stride-2 conv over a shard of {x.shape[1]} rows")
      x = space.halo(x, 0, 1).permute(0, 3, 1, 2)
      y = F.conv2d(F.pad(x, (0, 1)), w, b, stride=2)
    else:
      r = w.shape[-1] // 2
      y = F.conv2d(space.halo(x, r, r).permute(0, 3, 1, 2), w, b,
                   padding=(0, r))
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
    spatial.refuse("the legacy networks' Conv2d")
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
    self.dtype = torch.float32  # the compute dtype (module docstring)
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    o, i = self.weight.shape
    default_init(self.init_scale)(self.weight, i, o, generator)
    with torch.no_grad():
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                    self.bias.to(self.dtype))


def NIN(in_ch: int, out_ch: int, init_scale: float = 0.1) -> Dense:
  """1x1 "network-in-network": a dense layer over the channel axis."""
  return Dense(in_ch, out_ch, init_scale=init_scale)


class GroupNorm(nn.Module):
  """GroupNorm over an NHWC tensor, as ``flax.linen.GroupNorm`` computes it.

  Statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, then
  ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast once to
  ``dtype`` (Flax's ``dtype=``; None, the default: the input's dtype
  promoted with the f32 parameters'). Under a space axis the sums of x and
  x^2 per (sample, group) are summed over the axis."""

  def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
    super().__init__()
    self.num_groups = num_groups
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))
    self.dtype = None

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self.weight.fill_(1.0)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    g = self.num_groups
    xg = x.float().reshape(n, h * w, g, c // g)
    space = spatial.current()
    if space is None:
      mean = xg.mean(dim=(1, 3), keepdim=True)
      mean2 = xg.square().mean(dim=(1, 3), keepdim=True)
    else:
      sums = space.sum(torch.stack([xg.sum(dim=(1, 3), keepdim=True),
                                    xg.square().sum(dim=(1, 3),
                                                    keepdim=True)]))
      mean, mean2 = sums / (h * space.size * w * (c // g))
    var = (mean2 - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
    y = (xg - mean) * mul + self.bias.reshape(g, c // g)
    dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
    return y.reshape(n, h, w, c).to(dtype)


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
  with the softmax in f32. Both products sum in f32 (JAX's
  ``preferred_element_type``) over q, k and v's values; the weights are
  cast to v's dtype first and the output is in v's dtype. ``k`` and ``v``
  may hold more rows than ``q`` (the whole image's, for a shard's
  queries)."""
  b, h, w, c = q.shape
  q = q.reshape(b, h * w, c)
  k = k.reshape(b, -1, c)
  v = v.reshape(b, -1, c)
  logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * (int(c) ** -0.5)
  weights = torch.softmax(logits, dim=-1)
  out = torch.bmm(weights.to(v.dtype).float(), v.float())
  return out.reshape(b, h, w, c).to(v.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """:func:`spatial_attention`; under a space axis the queries of this
  rank's rows against the keys and values of every rank's."""
  space = spatial.current()
  if space is not None:
    k, v = space.gather(torch.cat([k, v], dim=-1)).split(k.shape[-1], dim=-1)
  return spatial_attention(q, k, v)


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
    h = attend(self.q(h), self.k(h), self.v(h))
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
