"""float8 activation storage for the convolutions (``tpu.activation_dtype``).

Counterpart of ``soft_truncation_tpu/ops/quant.py``. With
``config.tpu.activation_dtype = 'float8_e4m3'`` each quantized conv rounds
its input activation to e4m3 and keeps that e4m3 copy (1 byte per element)
for the backward in place of the f32 input; the backward computes dx from
the cotangent rounded through e5m2, and dw from the raw cotangent against
the upcast e4m3 copy. Weights, biases, norms and the optimizer stay f32.

The convolutions themselves are ``torch.nn.functional.conv2d`` and its
``torch.nn.grad`` helpers, as the JAX package's are ``lax.conv`` outside
any Pallas call; run them in f32 with TF32 off, as the rest of the port,
or in the compute dtype (``config.tpu.compute_dtype`` = 'bfloat16'): as
the JAX package's ``fp8_conv(..., compute_dtype)``, the input and weight
come in that dtype, the e4m3 copy is upcast to it, the output and both
gradients are in it, and dx reads the e5m2-rounded cotangent in it.

:func:`round_e4m3` / :func:`round_e5m2` round f32 to the nearest value of
the 8-bit format (ties to even) and return it in f32, as ml_dtypes'
``astype(float8_e4m3fn)`` / ``astype(float8_e5m2)`` followed by an upcast
gives it, bit for bit, on the CPU and on the card. They do not use torch's
float8 cast, which saturates: e4m3fn has no infinity, and ml_dtypes (so
JAX) turns a finite value that rounds past 448 (above 464), and +-inf,
into NaN, where ``Tensor.to(torch.float8_e4m3fn)`` gives +-448. e5m2 goes
to +-inf past 57344 (from 61440 on) in both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.layers import DDPMConv
from ..parallel import spatial

#: config.tpu.activation_dtype values this module implements.
SUPPORTED = ("float8_e4m3",)

_SIGN = -(2 ** 31)        # 0x80000000 as an int32
_QUIET_NAN = 0x7FC00000   # ml_dtypes' NaN, carrying the input's sign
_EXP_MASK = 0xFF


class _Format:
  """An 8-bit float format: its mantissa bits, least normal exponent and
  largest finite value."""

  def __init__(self, mantissa_bits: int, min_exp: int, max_finite: float,
               has_inf: bool):
    self.mantissa_bits = mantissa_bits
    self.min_exp = min_exp
    self.max_finite = max_finite
    self.has_inf = has_inf


E4M3 = _Format(3, -6, 448.0, has_inf=False)
E5M2 = _Format(2, -14, 57344.0, has_inf=True)


def _pow2(exp: torch.Tensor) -> torch.Tensor:
  """2**exp in f32 for int32 exponents in the normal range, built from its
  bits (exact on every device)."""
  return ((exp + 127) << 23).view(torch.float32)


def _round(x: torch.Tensor, fmt: _Format) -> torch.Tensor:
  if x.dtype != torch.float32:
    raise TypeError(f"float8 rounding takes float32, got {x.dtype}")
  bits = x.view(torch.int32)
  exp = ((bits >> 23) & _EXP_MASK) - 127        # f32 subnormals: -127
  # the spacing of the format's values around x: 2^(e - m), and the
  # subnormals' fixed spacing below the least normal exponent
  q = (exp.clamp(fmt.min_exp, 125) - fmt.mantissa_bits)
  y = torch.round(x * _pow2(-q)) * _pow2(q)    # ties to even; exact scalings
  over = y.abs() > fmt.max_finite
  if fmt.has_inf:
    y = torch.where(over | torch.isinf(x),
                    torch.copysign(torch.full_like(x, float("inf")), x), y)
    nan = torch.isnan(x)
  else:
    nan = over | torch.isinf(x) | torch.isnan(x)
  out = torch.where(nan, (bits & _SIGN) | _QUIET_NAN, y.view(torch.int32))
  return out.view(torch.float32)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
  """f32 -> the nearest float8_e4m3fn value, in f32 (NaN past the range)."""
  return _round(x, E4M3)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
  """f32 -> the nearest float8_e5m2 value, in f32 (+-inf past the range)."""
  return _round(x, E5M2)


Padding = Union[str, Sequence[Tuple[int, int]]]


def _pads(padding: Padding, x_hw, w_hw, stride: int) -> Tuple[int, ...]:
  """``F.pad`` widths (left, right, top, bottom) of an NCHW input for
  ``padding``: 'SAME' (XLA's split, the extra row or column at the end),
  'VALID', or ((top, bottom), (left, right))."""
  if isinstance(padding, str):
    if padding == "VALID":
      return (0, 0, 0, 0)
    if padding != "SAME":
      raise ValueError(f"padding {padding!r}")
    pads = []
    for size, k in zip(x_hw, w_hw):
      out = -(-size // stride)
      total = max((out - 1) * stride + k - size, 0)
      pads.append((total // 2, total - total // 2))
  else:
    pads = [tuple(int(p) for p in pair) for pair in padding]
  (top, bottom), (left, right) = pads
  return (left, right, top, bottom)


class _Fp8Conv(torch.autograd.Function):
  """NCHW conv of the e4m3-rounded input; saves the e4m3 copy, not x."""

  @staticmethod
  def forward(ctx, x, w, stride, pads):
    # x and w in the compute dtype; e4m3's values are exact in f32 and bf16
    x8 = round_e4m3(x.float()).to(x.dtype)
    ctx.stride, ctx.pads, ctx.x_shape = stride, pads, x.shape
    # the values are e4m3's (NaN past its range), so this cast is exact
    ctx.save_for_backward(x8.to(torch.float8_e4m3fn), w)
    return F.conv2d(F.pad(x8, pads), w, stride=stride)

  @staticmethod
  def backward(ctx, g):
    x8, w = ctx.saved_tensors
    xp = F.pad(x8.to(w.dtype), ctx.pads)
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dxp = torch.nn.grad.conv2d_input(xp.shape, w,
                                       round_e5m2(g.float()).to(g.dtype),
                                       stride=ctx.stride)
      left, right, top, bottom = ctx.pads
      h, w_ = ctx.x_shape[-2:]
      dx = dxp[..., top:top + h, left:left + w_]
    if ctx.needs_input_grad[1]:
      dw = torch.nn.grad.conv2d_weight(xp, w.shape, g, stride=ctx.stride)
    return dx, dw, None, None


def fp8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             padding: Padding = "SAME") -> torch.Tensor:
  """NHWC conv (``w`` OIHW, no bias) whose input is stored as e4m3.

  The forward convolves ``round_e4m3(x)``; the backward gives dx from the
  e5m2-rounded cotangent and dw from the raw cotangent against the saved
  e4m3 copy, as the JAX package's ``fp8_conv`` custom VJP does. ``x`` and
  ``w`` come in one dtype, the compute dtype (f32 or bf16), which the
  output and the gradients take."""
  xc = x.permute(0, 3, 1, 2)
  pads = _pads(padding, xc.shape[-2:], w.shape[-2:], stride)
  return _Fp8Conv.apply(xc, w, stride, pads).permute(0, 2, 3, 1)


class QConv(DDPMConv):
  """Drop-in for :class:`DDPMConv` (the same parameters, names and init)
  whose input activation is stored as e4m3 (:func:`fp8_conv`). Its weight
  operands for the fused kernel (``weight_hwio``) are DDPMConv's: the fused
  sites run unquantized, as in the JAX package."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
               init_scale: float = 1.0, stride: int = 1,
               act_quant: Optional[str] = "float8_e4m3"):
    if act_quant not in SUPPORTED:
      raise NotImplementedError(
          f"tpu.activation_dtype={act_quant!r}; supported: {SUPPORTED}")
    super().__init__(in_ch, out_ch, kernel_size, init_scale, stride)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    spatial.refuse("an fp8 conv (tpu.activation_dtype)")
    padding = ((0, 1), (0, 1)) if self.stride == 2 else "SAME"
    w, b = self.compute_params()
    return fp8_conv(x.to(self.dtype), w, self.stride, padding) + b
