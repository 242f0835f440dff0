"""2x FIR up/down-sampling (NHWC) for Hopper, with its adjoint.

Counterpart of ``soft_truncation_tpu/ops/pallas/fir.py``: the separable
polyphase resampler that ``ops/resample.py::upsample_2d`` /
``downsample_2d`` take at factor 2 with a 1-D kernel. The per-axis taps
(``k / sum(k) * sqrt(gain)``, doubled for up) and the pads are those of
the JAX package's ``_fir2_op``, computed on the host in float64 once per
(taps, gain, mode) by the cached launch plan ``_plan``, which also holds
the kernel's tap table as a ready ctypes array: a call on the card touches
no numpy. The resample itself is one hand-written CUDA kernel
(``csrc/fir2.cu``) that sums over both axes in one pass.

:func:`fir_upsample2` / :func:`fir_downsample2` launch the kernel for CUDA
tensors and take the plain versions, :func:`fir_upsample2_plain` /
:func:`fir_downsample2_plain`, only for CPU tensors. Both are a
``torch.autograd.Function`` whose backward is the exact adjoint, chosen
statically as the JAX package's ``_fir2_bwd`` chooses it:

- even T (every config's ``[1, 3, 3, 1]``): the same Function in the other
  mode with the taps reversed and the gain 4g (adjoint of up) or g/4
  (adjoint of down), its output sized to the forward's input; the mirrored
  pads coincide with ``fir2_pads``, so on the card the backward launches
  the same ``fir2`` kernel, and double backward follows. The output size
  matters for a downsample of an odd-sized input 2M+1: its adjoint is the
  upsample of the M-sized cotangent to 2M+1 rows, not 2M (taps that fall
  past the cotangent read zero, as everywhere);
- odd T: the transpose of the general ``upfirdn2d`` formulation (autograd
  through its depthwise conv), as JAX takes ``jax.linear_transpose`` of
  ``_lax_equivalent``.

The resample is linear, so the Function's forward-mode rule (``jvp``, as
``torch.func.jvp`` takes it for the likelihood's divergence) is the same
resample of the tangent: on the card one more ``fir2`` launch.

Where no derivative can be asked of the call (under ``torch.no_grad`` /
``inference_mode`` with no forward-mode level open, as when serving), the
wrappers call the resample directly, without the Function
(``ops/_autodiff.py``).

The resample is also the operator ``soft_truncation::fir2`` (``x, taps,
gain, mode, out_hw, count_as``; ``ops/_build.py::define_op``): CPU = the
plain version, CUDA = the launch (:func:`_resample_cuda`, which counts it
as ``count_as`` names), fake = the output's shape. Every call goes
through it, traced (``torch.export``) or eager.

Each wrapper counts its forward launches in ``.launches`` and, per input
``(H, W, C)``, in ``.launches_by_shape``; the launches its backward makes
(in the other mode) in ``.backward_launches`` and, per cotangent
``(H, W, C)``, in ``.backward_launches_by_shape``; its tangents'
launches in ``.jvp_launches`` and, per tangent ``(H, W, C)``, in
``.jvp_launches_by_shape``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ._autodiff import below_transforms, plain, records_derivatives
from ._build import define_op, launch, load_library, tracing

_KERNEL = "fir2"
MAX_TAPS = 8


def _phase_taps_up2(T: int, pad0: int) -> Tuple[List, List]:
  """For each output phase p of up2, the (kernel index, input offset)
  pairs: ``out[2i+p] = sum K[ki] * x[i + offset]`` (K unflipped)."""
  phases = []
  for p in (0, 1):
    phases.append([(T - 1 - t, (p + t - pad0) // 2) for t in range(T)
                   if (p + t - pad0) % 2 == 0])
  return phases[0], phases[1]


def fir2_pads(T: int, mode: str) -> Tuple[int, int]:
  """Leading and trailing pad per axis of a T-tap 2x resample."""
  p = T - 2
  if mode == "up":
    return (p + 1) // 2 + 1, p // 2
  return (p + 1) // 2, p // 2


def fir2_taps(k: Sequence[float], gain: float, mode: str) -> np.ndarray:
  """Per-axis taps in float64: ``k / sum(k) * sqrt(gain)``, x2 for up."""
  k = np.asarray(k, dtype=np.float64)
  if k.ndim != 1:
    raise ValueError(f"the 2x FIR kernel is separable: k must be 1-D, got "
                     f"shape {k.shape}")
  if not 1 <= k.shape[0] <= MAX_TAPS:
    raise ValueError(f"the 2x FIR kernel takes 1..{MAX_TAPS} taps, got "
                     f"{k.shape[0]}")
  return k / np.sum(k) * (math.sqrt(gain) * (2.0 if mode == "up" else 1.0))


class _Plan(NamedTuple):
  """What a 2x FIR resample needs, per (taps, gain, mode): see _plan."""
  taps: np.ndarray      # per-axis taps in f32, unflipped (fir2_taps)
  T: int
  pad0: int
  pad1: int
  up: int               # 1 for up2, 0 for down2
  length: int           # the kernel's table length: S (up2) or T (down2)
  base: int             # first input offset lo (up2) or pad0 (down2)
  table: ctypes.Array   # the kernel's f32 table (fir2.cu's ``Table``)


def _up2_phase_table(taps: np.ndarray, pad0: int):
  """Up2's two phases over the input offsets they share: ``(lo, coef)``
  with ``out[2i+p] = sum_s coef[p, s] * x[i + lo + s]``, coef [2, S] f32
  (0 where phase p has no tap at that offset), from _phase_taps_up2."""
  phases = _phase_taps_up2(len(taps), pad0)
  offsets = [o for phase in phases for _, o in phase]
  lo = min(offsets)
  coef = np.zeros((2, max(offsets) - lo + 1), np.float32)
  for p, phase in enumerate(phases):
    for ki, o in phase:
      coef[p, o - lo] = taps[ki]
  return lo, coef


@functools.lru_cache(maxsize=None)
def _plan(k: Tuple[float, ...], gain: float, mode: str) -> _Plan:
  """The launch plan of one (taps, gain, mode), computed once: the taps and
  pads, and the kernel's table as a ready ctypes array. Raises as
  :func:`fir2_taps` does for what the kernel does not take."""
  taps = fir2_taps(k, gain, mode).astype(np.float32)
  T = len(taps)
  pad0, pad1 = fir2_pads(T, mode)
  if mode == "up":
    base, coef = _up2_phase_table(taps, pad0)
    length, values = coef.shape[1], coef.ravel()
  else:
    base, length, values = pad0, T, taps[::-1]
  table = (ctypes.c_float * len(values))(*values.tolist())
  return _Plan(taps, T, pad0, pad1, int(mode == "up"), length, base, table)


def _taps_key(k) -> Tuple[float, ...]:
  """``k`` as a tuple of floats, the plan's key; a tuple or list of numbers
  takes no numpy."""
  if isinstance(k, (tuple, list)):
    try:
      return tuple(float(v) for v in k)
    except TypeError:  # nested: let fir2_taps name the shape
      pass
  k = np.asarray(k, dtype=np.float64)
  if k.ndim != 1:
    fir2_taps(k, 1.0, "up")  # raises
  return tuple(k.tolist())


def _out_size(L: int, T: int, mode: str) -> int:
  if mode == "up":
    return 2 * L
  pad0, pad1 = fir2_pads(T, mode)
  return (L + pad0 + pad1 - T) // 2 + 1


def _take(x, dim: int, start: int, n: int):
  """``x[start:start+n]`` along ``dim``, zero outside ``[0, L)``."""
  L = x.shape[dim]
  lo, hi = max(start, 0), min(start + n, L)
  if hi <= lo:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)
  pad = [0, 0] * (x.dim() - 1 - dim) + [lo - start, start + n - hi]
  return torch.nn.functional.pad(x.narrow(dim, lo, hi - lo), pad)


def _up2_axis(x, k: np.ndarray, pad0: int, dim: int, n: int):
  """Polyphase 2x upsample + FIR along ``dim`` (``_up2_axis`` of JAX), the
  first ``n`` outputs of the upsample of ``x`` zero-extended."""
  if n > 2 * x.shape[dim]:
    x = _take(x, dim, 0, (n + 1) // 2)
  L = x.shape[dim]
  outs = []
  for taps in _phase_taps_up2(len(k), pad0):
    acc = None
    for ki, o in taps:
      term = float(k[ki]) * _take(x, dim, o, L)
      acc = term if acc is None else acc + term
    outs.append(acc)
  shape = list(x.shape)
  shape[dim] = 2 * L
  return torch.stack(outs, dim=dim + 1).reshape(shape).narrow(dim, 0, n)


def _down2_axis(x, k: np.ndarray, pad0: int, dim: int, M: int):
  """FIR + 2x downsample along ``dim`` (``_down2_axis`` of JAX), ``M``
  outputs."""
  T = len(k)
  acc = None
  for t in range(T):
    # x_padded[2j + t] for j < M, a stride-2 slice
    term = float(k[T - 1 - t]) * _take(x, dim, t - pad0, 2 * M).unflatten(
        dim, (M, 2)).select(dim + 1, 0)
    acc = term if acc is None else acc + term
  return acc


def _fir2_plain(x, k, gain: float, mode: str, out_hw=None):
  plan = _plan(_taps_key(k), float(gain), mode)
  oh, ow = _check(tuple(x.shape), plan, mode, out_hw)
  f = _up2_axis if mode == "up" else _down2_axis
  return f(f(x, plan.taps, plan.pad0, 1, oh), plan.taps, plan.pad0, 2, ow)


def fir_upsample2_plain(x, k: Sequence[float], gain: float = 1.0):
  """Plain torch 2x FIR upsample of NHWC ``x``, as
  ``ops/resample.py::upsample_2d(x, k, factor=2, gain)`` with a 1-D ``k``.
  The CPU path and the reference the kernel is held against on the card."""
  return _fir2_plain(x, k, gain, "up")


def fir_downsample2_plain(x, k: Sequence[float], gain: float = 1.0):
  """Plain torch 2x FIR downsample of NHWC ``x``, as
  ``downsample_2d(x, k, factor=2, gain)`` with a 1-D ``k``."""
  return _fir2_plain(x, k, gain, "down")


def _check(shape: tuple, plan: _Plan, mode: str, out_hw=None):
  """The output's (H, W) for x of ``shape``: ``out_hw``, or the resample's
  own size."""
  if len(shape) != 4:
    raise ValueError(f"x must be NHWC, got shape {shape}")
  n, h, w, c = shape
  oh, ow = out_hw or (_out_size(h, plan.T, mode), _out_size(w, plan.T, mode))
  if min(n, c, oh, ow) <= 0:
    raise ValueError(f"no output for x of shape {shape} and {plan.T} taps")
  return oh, ow


class _Args(ctypes.Structure):
  """fir2.cu's ``Fir2Args``: one launch's arguments besides the pointers,
  the vector width and the stream."""
  _fields_ = [(name, ctypes.c_int) for name in
              ("N", "H", "W", "C", "OH", "OW", "up", "len", "base")] + [
                  ("table", ctypes.c_float * 10)]


@functools.lru_cache(maxsize=None)
def _launch_args(k, gain: float, mode: str, shape: tuple, out_hw):
  """Per (taps, gain, mode, x's shape, out_hw), checked once: the output's
  shape and the kernel's ``_Args``."""
  plan = _plan(k, gain, mode)
  oh, ow = _check(shape, plan, mode, out_hw)
  n, h, w, c = shape
  if max(n * h * w * c, n * oh * ow * c) >= 2 ** 31:
    raise ValueError(f"the fir2 kernel indexes in 32 bits: x of shape "
                     f"{shape} is too large")
  return (n, oh, ow, c), _Args(n, h, w, c, oh, ow, plan.up, plan.length,
                               plan.base, (ctypes.c_float * 10)(*plan.table))


def _launch(x, k, gain: float, mode: str, out_hw, device: torch.device):
  """One launch of the fir2 kernel on the CUDA tensor ``x``."""
  if x.dtype != torch.float32:
    raise NotImplementedError(
        f"the fir2 kernel takes float32 only (x is {x.dtype}); bfloat16 "
        "is listed in ROADMAP.md Queue 2")
  if not x.is_contiguous():
    raise ValueError("x must be contiguous")
  out_shape, args = _launch_args(k, gain, mode, tuple(x.shape), out_hw)
  out = x.new_empty(out_shape)
  vec = 4 if out_shape[3] % 4 == 0 and x.data_ptr() % 16 == 0 else 1
  err = launch(_kernel_fn(), device, x.data_ptr(), out.data_ptr(),
               ctypes.addressof(args), vec)
  if err != 0:
    raise RuntimeError(f"fir2 launch failed: cudaError {err}")
  return out


def _count(counts: dict, key) -> None:
  counts[key] = counts.get(key, 0) + 1


_TALLIES = {"forward": ("launches", "launches_by_shape"),
            "backward": ("backward_launches", "backward_launches_by_shape"),
            "jvp": ("jvp_launches", "jvp_launches_by_shape")}


def _resample_cuda(x, k, gain: float, mode: str, wrapper, tally: str,
                   out_hw=None):
  """One launch of the kernel on the CUDA tensor ``x``, counted on
  ``wrapper`` as a ``tally`` ('forward', 'backward' or 'jvp') launch: the
  operator's CUDA implementation."""
  out = _launch(x, k, gain, mode, out_hw, x.device)
  total, by_shape = _TALLIES[tally]
  setattr(wrapper, total, getattr(wrapper, total) + 1)
  _count(getattr(wrapper, by_shape), tuple(x.shape[1:]))
  return out


def _op_args(taps, out_hw, count_as):
  """The operator's list arguments as the launch function takes them, and
  its ``count_as`` ('<up|down>:<tally>') as (wrapper, tally)."""
  wrapper, tally = count_as.split(":")
  return (tuple(taps), None if out_hw is None else tuple(out_hw),
          fir_upsample2 if wrapper == "up" else fir_downsample2, tally)


def _op_cpu(x, taps, gain, mode, out_hw, count_as):
  k, out_hw, _, _ = _op_args(taps, out_hw, count_as)
  return _fir2_plain(x, k, gain, mode, out_hw)


def _op_cuda(x, taps, gain, mode, out_hw, count_as):
  k, out_hw, wrapper, tally = _op_args(taps, out_hw, count_as)
  return _resample_cuda(x, k, gain, mode, wrapper, tally, out_hw)


def _op_fake(x, taps, gain, mode, out_hw, count_as):
  k, out_hw, _, _ = _op_args(taps, out_hw, count_as)
  n, _, _, c = x.shape
  oh, ow = _check(tuple(x.shape), _plan(k, float(gain), mode), mode, out_hw)
  return x.new_empty((n, oh, ow, c))


_OP = define_op(
    "fir2", "(Tensor x, float[] taps, float gain, str mode, int[]? out_hw, "
    "str count_as) -> Tensor", cpu=_op_cpu, cuda=_op_cuda, fake=_op_fake)


def _resample(x, k, gain: float, mode: str, wrapper, tally: str,
              out_hw=None):
  """The operator: the plain version for a CPU tensor, the kernel for a
  CUDA tensor, counted on ``wrapper`` as a ``tally`` ('forward',
  'backward' or 'jvp') launch; an opaque node while tracing."""
  if x.device.type not in ("cpu", "cuda") and not tracing():
    raise ValueError(f"fir_{mode}sample2 runs on cuda or cpu, not "
                     f"{x.device}")
  count_as = f"{'up' if wrapper is fir_upsample2 else 'down'}:{tally}"
  return _OP(x, list(k), gain, mode, None if out_hw is None else list(out_hw),
             count_as)


def _lax_equivalent(x, k, gain: float, mode: str):
  """The general ``upfirdn2d`` form of the same resample."""
  from .resample import setup_fir_kernel, upfirdn2d
  if mode == "up":
    k2 = setup_fir_kernel(k, gain * 4)
    p = k2.shape[0] - 2
    return upfirdn2d(x, k2, up=2, pad=((p + 1) // 2 + 1, p // 2))
  k2 = setup_fir_kernel(k, gain)
  p = k2.shape[0] - 2
  return upfirdn2d(x, k2, down=2, pad=((p + 1) // 2, p // 2))


def _transpose(ybar, k, gain: float, mode: str, in_shape):
  """Adjoint of :func:`_lax_equivalent` at ``ybar``, by autograd."""
  create_graph = torch.is_grad_enabled()
  with torch.enable_grad():
    x0 = ybar.new_zeros(in_shape, requires_grad=True)
    (xbar,) = torch.autograd.grad(_lax_equivalent(x0, k, gain, mode), x0,
                                  ybar, create_graph=create_graph)
  return xbar


class _Fir2(torch.autograd.Function):
  """A 2x FIR resample whose backward is its adjoint and whose forward-mode
  rule is itself (module docstring)."""

  @staticmethod
  def forward(x, k, gain, mode, wrapper, tally, out_hw):
    return _resample(x, k, gain, mode, wrapper, tally, out_hw)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, k, gain, mode, wrapper, _, out_hw = inputs
    ctx.args = (k, gain, mode, tuple(x.shape))
    ctx.jvp_args = (k, gain, mode, wrapper, "jvp", out_hw)

  @staticmethod
  def backward(ctx, ybar):
    return (fir2_backward(ybar, *ctx.args),) + (None,) * 6

  @staticmethod
  def jvp(ctx, dx, *_):
    dx = plain(dx)
    with below_transforms():
      return _resample(dx.contiguous(), *ctx.jvp_args)


def _apply(x, k, gain: float, mode: str, wrapper, tally: str, out_hw=None):
  """The resample, through the Function wherever a derivative can be
  asked of it."""
  if records_derivatives():
    return _Fir2.apply(x, k, gain, mode, wrapper, tally, out_hw)
  return _resample(x, k, gain, mode, wrapper, tally, out_hw)


def fir2_backward(ybar, k, gain: float, mode: str, x_shape):
  """The gradient that autograd hands back through ``fir_{mode}sample2(x,
  k, gain)`` for the cotangent ``ybar``, ``x`` being of ``x_shape``: for
  even T the kernel in the other mode at ``x``'s size (counted as a
  backward launch of the forward's wrapper), for odd T the transpose
  (module docstring)."""
  k = tuple(float(v) for v in k)
  if len(k) % 2 == 0:
    other, g = ("down", 4.0 * gain) if mode == "up" else ("up", gain / 4.0)
    wrapper = fir_upsample2 if mode == "up" else fir_downsample2
    return _apply(ybar.contiguous(), tuple(reversed(k)), g, other, wrapper,
                  "backward", tuple(x_shape[1:3]))
  return _transpose(ybar, k, gain, mode, x_shape)


def _fir2(x, k, gain: float, mode: str, wrapper):
  if type(k) is not tuple:  # the model's taps come as a tuple: used as is
    k = _taps_key(k)
  gain = float(gain)
  _plan(k, gain, mode)  # a 1-D kernel of 1..MAX_TAPS taps, or raise
  return _apply(x, k, gain, mode, wrapper, "forward")


def fir_upsample2(x, k: Sequence[float], gain: float = 1.0):
  """2x FIR upsample of NHWC float32 ``x`` with the separable kernel ``k``
  (1-D, <= 8 taps): [N, H, W, C] -> [N, 2H, 2W, C]. A CUDA tensor launches
  the kernel; a CPU tensor takes :func:`fir_upsample2_plain`.
  Differentiable in both modes: the backward is the exact adjoint, the
  forward-mode rule the same resample of the tangent."""
  return _fir2(x, k, gain, "up", fir_upsample2)


def fir_downsample2(x, k: Sequence[float], gain: float = 1.0):
  """2x FIR downsample of NHWC float32 ``x`` with the separable kernel
  ``k`` (1-D, <= 8 taps): [N, H, W, C] -> [N, H/2, W/2, C] for even sizes.
  A CUDA tensor launches the kernel; a CPU tensor takes
  :func:`fir_downsample2_plain`. Differentiable in both modes, as
  :func:`fir_upsample2`."""
  return _fir2(x, k, gain, "down", fir_downsample2)


def reset_launch_counts() -> None:
  """Set both wrappers' launch counts (forward, backward and tangent, total
  and per shape) to zero."""
  for wrapper in (fir_upsample2, fir_downsample2):
    for total, by_shape in _TALLIES.values():
      setattr(wrapper, total, 0)
      setattr(wrapper, by_shape, {})


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
  fn = load_library(_KERNEL).fir2_f32
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn
