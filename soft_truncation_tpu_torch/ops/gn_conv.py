"""Fused GroupNorm-apply + SiLU + 3x3 conv (NHWC), for Hopper, with its
forward-mode derivative.

Counterpart of ``soft_truncation_tpu/ops/pallas/gn_conv.py``. The GroupNorm
statistics (:func:`gn_stats`) stay plain torch ops, as the JAX package
leaves them to XLA; the rest, ``conv3x3(SiLU(x*scale + shift), zero pad) +
b`` with the fold of stats and affine into ``scale, shift``, is one
hand-written CUDA kernel (``csrc/gn_silu_conv3x3.cu``): an implicit GEMM on
the tensor cores in 3xTF32, with split-K where the tiles alone would leave
SMs idle. The normalised slab never reaches device memory.

:func:`gn_silu_conv3x3` launches the kernel for CUDA tensors and takes the
plain version, :func:`gn_silu_conv3x3_plain`, only for CPU tensors. The
kernel's tiling (:func:`launch_plan`) and its operand split
(:func:`tf32_split`, :func:`weight_operand`) are plain Python here, so the
CPU tests can replay its arithmetic.

Forward mode (``torch.func.jvp``, as the likelihood takes the Hutchinson
divergence): with tangents of ``x`` and of the stats (gamma, beta, w and b
held constant), the output's tangent is ``conv3x3(SiLU'(a) * da)``, no
bias (:func:`gn_silu_conv3x3_jvp_plain` writes it out). The same ``.cu``
file computes it in a tangent mode (:func:`gn_silu_conv3x3_jvp`), and the
wrapper's ``torch.autograd.Function`` names it as its ``jvp`` rule, so
under ``torch.func.jvp`` each fused site launches the kernel twice, for
the primal and for the tangent. There is no reverse-mode rule: the
Function's backward refuses, as the JAX package has no VJP for its kernel.
Where no derivative can be asked of the call (serving) the wrapper calls
the kernel directly, without the Function (``ops/_autodiff.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._autodiff import below_transforms, plain, records_derivatives
from ._build import launch, load_library

_KERNEL = "gn_silu_conv3x3"
_FORWARD_ONLY = ("gn_silu_conv3x3 is forward-only: call it under "
                 "torch.no_grad() or torch.inference_mode()")
# csrc/gn_silu_conv3x3.cu's tile (BM GEMM rows, BN output channels, BK
# channels per chunk) and the blocks an SM holds
BM, BN, BK = 128, 128, 16
BLOCKS_PER_SM = 2
_MAX_SMEM = 232448     # a block's dynamic shared memory, at most
_SM_SMEM = 233472      # an SM's shared memory, 1 KB of it reserved per block
H100_SMS = 132


def gn_stats(x: torch.Tensor, groups: int = 32, eps: float = 1e-6):
  """Per-(sample, group) ``(mean, rsqrt)`` of an NHWC tensor, in f32."""
  n, h, w, c = x.shape
  xg = x.float().reshape(n, h * w, groups, c // groups)
  mean = xg.mean(dim=(1, 3))
  var = xg.square().mean(dim=(1, 3)) - mean.square()
  return mean, torch.rsqrt(var + eps)


def _fold(mean, rsqrt, gamma, beta, groups: int):
  """Per-(sample, channel) ``scale, shift`` with x*scale + shift == GN(x)."""
  cg = gamma.shape[0] // groups
  scale = rsqrt.repeat_interleave(cg, dim=1) * gamma[None, :]
  shift = beta[None, :] - mean.repeat_interleave(cg, dim=1) * scale
  return scale.float().contiguous(), shift.float().contiguous()


def _check(x, mean, rsqrt, gamma, beta, w, b, groups: int):
  if x.dim() != 4:
    raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
  n, _, _, c = x.shape
  if groups <= 0 or c % groups:
    raise ValueError(f"channels {c} are not divisible by groups {groups}")
  o = w.shape[-1]
  tensors = (mean, rsqrt, gamma, beta, w, b)
  shapes = ((n, groups), (n, groups), (c,), (c,), (3, 3, c, o), (o,))
  device = x.device
  if (tuple(t.shape for t in tensors) == shapes
      and all(t.device == device for t in tensors)):
    return
  for name, t, shape in zip(("mean", "rsqrt", "gamma", "beta", "w", "b"),
                            tensors, shapes):
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} must have shape {shape}, got "
                       f"{tuple(t.shape)}")
    if t.device != device:
      raise ValueError(f"{name} is on {t.device}, x on {device}")


def gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b,
                          groups: int = 32) -> torch.Tensor:
  """Plain torch version: GroupNorm apply, SiLU, zero pad, conv2d.

  Same arguments and result as :func:`gn_silu_conv3x3`. The CPU path of
  the model and the reference the kernel is held against on the card."""
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  scale, shift = _fold(mean, rsqrt, gamma, beta, groups)
  act = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
  act = F.pad(act.permute(0, 3, 1, 2), (1, 1, 1, 1))  # NCHW, zeros
  out = F.conv2d(act, w.float().permute(3, 2, 0, 1), b.float())
  return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check_tangents(x, dx, dmean, drsqrt, groups: int):
  n = x.shape[0]
  for name, t, shape in (("dx", dx, tuple(x.shape)),
                         ("dmean", dmean, (n, groups)),
                         ("drsqrt", drsqrt, (n, groups))):
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} must have shape {shape}, got "
                       f"{tuple(t.shape)}")
    if t.device != x.device:
      raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt, drsqrt, gamma,
                              beta, w, groups: int = 32) -> torch.Tensor:
  """Plain torch tangent of :func:`gn_silu_conv3x3` for tangents ``dx``,
  ``dmean``, ``drsqrt`` of ``x``, ``mean``, ``rsqrt`` (gamma, beta, w and b
  constant): ``conv3x3(SiLU'(a) * da, zero pad)``, no bias, with
  ``a = x*scale + shift``, ``da = dx*scale + x*dscale + dshift``,
  ``dscale = drsqrt_g * gamma``, ``dshift = -(dmean_g*scale +
  mean_g*dscale)`` and ``SiLU'(a) = s(1 + a(1 - s))``, s = sigmoid(a).
  Written out from that formula; the CPU path of the tangent and the
  reference the tangent kernel is held against on the card."""
  _check(x, mean, rsqrt, gamma, beta, w, w.new_empty(w.shape[-1]), groups)
  _check_tangents(x, dx, dmean, drsqrt, groups)
  scale, shift = _fold(mean, rsqrt, gamma, beta, groups)
  cg = gamma.shape[0] // groups
  dscale = drsqrt.float().repeat_interleave(cg, dim=1) * gamma.float()[None]
  dshift = -(dmean.float().repeat_interleave(cg, dim=1) * scale
             + mean.float().repeat_interleave(cg, dim=1) * dscale)

  def per_channel(t):
    return t[:, None, None, :]

  xf = x.float()
  a = xf * per_channel(scale) + per_channel(shift)
  da = (dx.float() * per_channel(scale) + xf * per_channel(dscale)
        + per_channel(dshift))
  s = torch.sigmoid(a)
  act = F.pad((s * (1.0 + a * (1.0 - s)) * da).permute(0, 3, 1, 2),
              (1, 1, 1, 1))
  out = F.conv2d(act, w.float().permute(3, 2, 0, 1))
  return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


class LaunchPlan(NamedTuple):
  """How the kernel tiles one (N, H, W, C, O): see :func:`launch_plan`."""
  cp: int       # C padded to a multiple of BK
  op: int       # O padded to a multiple of BN
  m: int        # N*H*W, the GEMM's rows
  rows: int     # pixel rows per block: BM // W, its GEMM rows rows * W
  grid: tuple   # (O tiles, row tiles, splits)
  chunks: int   # cp / BK, each 9 K steps (one per tap)
  splits: int
  slots: int    # images the block's rows + 2 halo rows can touch
  smem: int     # dynamic shared memory, bytes


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, c: int, o: int, groups: int,
                sms: int = H100_SMS, tangent: bool = False) -> LaunchPlan:
  """The kernel's grid for one shape: blocks of BM // W whole pixel rows
  (flattened across images) x BN output channels and, where they are
  fewer than the blocks the SMs hold at once (BLOCKS_PER_SM each, fewer
  where the shared memory does not fit them), split-K over the C / BK
  chunks so that about that many blocks run, in one wave. Split s takes
  chunks [s * chunks // S, (s + 1) * chunks // S), all 9 taps of each.
  The tangent mode stages the halo rows of x and of its tangent, and the
  stats' tangents: twice the raw A tile and twice the stats."""
  cp, op = _padded(c, o)
  rows = BM // w
  tiles = -(-(n * h) // rows) * (op // BN)
  chunks = cp // BK
  slots = min(n, -(-(rows + 2) // h) + 1)
  hp = (rows + 2) * (w + 2)  # halo pixels
  streams = 2 if tangent else 1
  smem = 4 * (2 * streams * hp * BK + 2 * (hp + 1) * (BK + 4)
              + 4 * BK * (BN + 8) + 2 * cp + 2 * streams * slots * groups
              + 3 * BM)
  resident = max(1, min(BLOCKS_PER_SM, _SM_SMEM // (smem + 1024)))
  splits = max(1, min(round(resident * sms / tiles), chunks))
  return LaunchPlan(cp, op, n * h * w, rows,
                    (op // BN, -(-(n * h) // rows), splits), chunks, splits,
                    slots, smem)


def fits(n: int, h: int, w: int, c: int, o: int, groups: int) -> bool:
  """Whether the kernel takes this shape in both modes: rows of at most BM
  pixels, and each mode's tile within a block's shared memory. The
  models route any other site to the plain chain, decided per shape."""
  return w <= BM and all(
      launch_plan(n, h, w, c, o, groups, tangent=tangent).smem <= _MAX_SMEM
      for tangent in (False, True))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
  """f32 to the nearest TF32 (10-bit mantissa), ties away from zero: PTX's
  ``cvt.rna.tf32.f32``, done on the bits."""
  bits = t.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor):
  """``(hi, lo)`` with hi = tf32(t) and lo = tf32(t - hi)."""
  hi = tf32_round(t)
  return hi, tf32_round(t - hi)


def _padded(c: int, o: int):
  """C and O padded to the kernel's chunk (BK) and tile (BN) widths."""
  return -(-c // BK) * BK, -(-o // BN) * BN


def weight_operand(w: torch.Tensor):
  """The HWIO weights as the kernel reads them: [9*Cp, Op] (tap-major rows
  of Cp channels, zero padding), split into TF32 ``(hi, lo)``. A caller
  that launches the kernel on one weight value many times computes this
  once and passes it as ``w_split`` (``DDPMConv.weight_tf32_split``)."""
  c, o = w.shape[2], w.shape[3]
  cp, op = _padded(c, o)
  wp = w.new_zeros((9, cp, op), dtype=torch.float32)
  wp[:, :c, :o] = w.reshape(9, c, o)
  return tf32_split(wp.reshape(9 * cp, op))


def _kernel_operands(name, x, tensors, w, groups, w_split, tangent):
  """Check what the kernel takes (f32, contiguous, 16-byte chunks of x, W,
  shared memory) and return its launch plan and weight operand."""
  for tname, t in tensors:
    if t.dtype != torch.float32:
      raise NotImplementedError(
          f"{name} kernel takes float32 only ({tname} is {t.dtype}); "
          f"bfloat16 is listed in ROADMAP.md Queue 2")
    if not t.is_contiguous():
      raise ValueError(f"{tname} must be contiguous")
  n, h, wd, c = x.shape
  o = w.shape[-1]
  if c % 4 or any(t.data_ptr() % 16 for tname, t in tensors
                  if tname in ("x", "dx")):
    raise NotImplementedError(f"the {name} kernel copies 16-byte chunks: "
                              f"C = {c} must be a multiple of 4 and x (and "
                              f"dx) 16-byte aligned")
  if wd > BM:
    raise NotImplementedError(f"the {name} kernel takes rows of at most "
                              f"{BM} pixels, not W = {wd}")
  plan = launch_plan(n, h, wd, c, o, groups, _sms(x.device), tangent)
  if plan.smem > _MAX_SMEM:
    raise NotImplementedError(f"{name}: a tile of {plan.rows} rows of {wd} "
                              f"pixels, {c} channels and {groups} groups "
                              f"exceeds shared memory")
  if w_split is None:
    w_split = weight_operand(w)
  w_hi, w_lo = w_split
  if (w_hi.shape != (9 * plan.cp, plan.op) or w_lo.shape != w_hi.shape
      or w_hi.device != x.device or w_lo.device != x.device):
    raise ValueError(f"w_split must be two [{9 * plan.cp}, {plan.op}] "
                     f"tensors on {x.device}, from weight_operand(w)")
  return plan, w_hi, w_lo


def _count(counts: dict, key) -> None:
  counts[key] = counts.get(key, 0) + 1


def _primal(x, mean, rsqrt, gamma, beta, w, b, groups: int, w_split):
  """The plain version for a CPU tensor, one launch for a CUDA tensor."""
  if x.device.type == "cpu":
    return gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b, groups)
  if x.device.type != "cuda":
    raise ValueError(f"gn_silu_conv3x3 runs on cuda or cpu, not {x.device}")
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  plan, w_hi, w_lo = _kernel_operands(
      "gn_silu_conv3x3", x, (("x", x), ("w", w), ("b", b), ("gamma", gamma),
                             ("beta", beta)), w, groups, w_split, False)
  n, h, wd, c = x.shape
  o = w.shape[-1]
  mean = mean.float().contiguous()
  rsqrt = rsqrt.float().contiguous()
  out = x.new_empty((n, h, wd, o))
  ws = x.new_empty((plan.splits, plan.m, o)) if plan.splits > 1 else None
  err = launch(_kernel_fn(), x.device, x.data_ptr(), mean.data_ptr(),
               rsqrt.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
               w_hi.data_ptr(), w_lo.data_ptr(), b.data_ptr(), out.data_ptr(),
               0 if ws is None else ws.data_ptr(), n, h, wd, c, o, groups,
               plan.cp, plan.op, plan.rows, plan.splits, plan.slots)
  if err != 0:
    raise RuntimeError(f"gn_silu_conv3x3 launch failed: cudaError {err}")
  gn_silu_conv3x3.launches += 1
  _count(gn_silu_conv3x3.launches_by_shape, (h, wd, c, o))
  return out


def gn_silu_conv3x3_jvp(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w,
                        groups: int = 32, w_split=None) -> torch.Tensor:
  """The tangent of :func:`gn_silu_conv3x3` (see
  :func:`gn_silu_conv3x3_jvp_plain`): a CUDA tensor launches the kernel in
  its tangent mode and counts the launch in
  ``gn_silu_conv3x3.jvp_launches`` and, per ``(H, W, C, O)``, in
  ``gn_silu_conv3x3.jvp_launches_by_shape``; a CPU tensor takes the plain
  version. ``w_split`` as for :func:`gn_silu_conv3x3`."""
  if x.device.type == "cpu":
    return gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt, drsqrt,
                                     gamma, beta, w, groups)
  if x.device.type != "cuda":
    raise ValueError(f"gn_silu_conv3x3 runs on cuda or cpu, not {x.device}")
  _check(x, mean, rsqrt, gamma, beta, w, w.new_empty(w.shape[-1]), groups)
  _check_tangents(x, dx, dmean, drsqrt, groups)
  plan, w_hi, w_lo = _kernel_operands(
      "gn_silu_conv3x3 tangent", x, (("x", x), ("dx", dx), ("w", w),
                                     ("gamma", gamma), ("beta", beta)),
      w, groups, w_split, True)
  n, h, wd, c = x.shape
  o = w.shape[-1]
  stats = [t.float().contiguous() for t in (mean, dmean, rsqrt, drsqrt)]
  out = x.new_empty((n, h, wd, o))
  ws = x.new_empty((plan.splits, plan.m, o)) if plan.splits > 1 else None
  err = launch(_jvp_kernel_fn(), x.device, x.data_ptr(), dx.data_ptr(),
               *(t.data_ptr() for t in stats), gamma.data_ptr(),
               beta.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
               out.data_ptr(), 0 if ws is None else ws.data_ptr(), n, h, wd,
               c, o, groups, plan.cp, plan.op, plan.rows, plan.splits,
               plan.slots)
  if err != 0:
    raise RuntimeError(f"gn_silu_conv3x3 tangent launch failed: cudaError "
                       f"{err}")
  gn_silu_conv3x3.jvp_launches += 1
  _count(gn_silu_conv3x3.jvp_launches_by_shape, (h, wd, c, o))
  return out


class _GnSiluConv3x3(torch.autograd.Function):
  """The fused call with a forward-mode rule (its tangent kernel) and a
  backward that refuses (module docstring)."""

  @staticmethod
  def forward(x, mean, rsqrt, gamma, beta, w, b, groups, w_split):
    return _primal(x, mean, rsqrt, gamma, beta, w, b, groups, w_split)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, mean, rsqrt, gamma, beta, w, _, groups, w_split = inputs
    ctx.set_materialize_grads(False)  # a constant's tangent stays None
    ctx.save_for_forward(x, mean, rsqrt, gamma, beta, w)
    ctx.groups, ctx.w_split = groups, w_split

  @staticmethod
  def jvp(ctx, dx, dmean, drsqrt, dgamma, dbeta, dw, db, *_):
    if any(t is not None for t in (dgamma, dbeta, dw, db)):
      raise NotImplementedError("gn_silu_conv3x3's jvp holds gamma, beta, w "
                                "and b constant")
    x, mean, rsqrt, gamma, beta, w = map(plain, ctx.saved_tensors)
    tangents = [None if t is None else plain(t) for t in (dx, dmean, drsqrt)]
    w_split = ctx.w_split and tuple(map(plain, ctx.w_split))
    with below_transforms():
      dx, dmean, drsqrt = (torch.zeros_like(p) if t is None else t
                           for t, p in zip(tangents, (x, mean, rsqrt)))
      return gn_silu_conv3x3_jvp(x, dx.contiguous(), mean, dmean, rsqrt,
                                 drsqrt, gamma, beta, w, ctx.groups, w_split)

  @staticmethod
  def backward(ctx, *grads):
    raise RuntimeError(_FORWARD_ONLY)


def gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, w, b, groups: int = 32,
                    w_split=None) -> torch.Tensor:
  """``conv3x3(silu((x - mean_g) * rsqrt_g * gamma + beta), SAME) + b``.

  x: [N, H, W, C]; mean/rsqrt: [N, G] per-(sample, group) statistics
  (rsqrt = 1/sqrt(var + eps)); gamma/beta: [C]; w: [3, 3, C, O]; b: [O].
  Returns [N, H, W, O] in x's dtype. A CUDA tensor launches the kernel
  and counts the launch in ``gn_silu_conv3x3.launches`` and, per
  ``(H, W, C, O)``, in ``gn_silu_conv3x3.launches_by_shape``; a CPU tensor
  takes the plain version. Forward and forward mode only: under
  ``torch.func.jvp`` the tangent is :func:`gn_silu_conv3x3_jvp`, and a
  backward through the call raises. ``w_split`` is ``weight_operand(w)``
  where the caller keeps it per weight value; without it the kernel's call
  splits ``w`` itself. The CPU path does not read it.
  """
  if records_derivatives():
    return _GnSiluConv3x3.apply(x, mean, rsqrt, gamma, beta, w, b, groups,
                                w_split)
  return _primal(x, mean, rsqrt, gamma, beta, w, b, groups, w_split)


def reset_launch_counts() -> None:
  """Set the kernel's launch counts, primal and tangent (total and per
  shape), to zero."""
  gn_silu_conv3x3.launches = 0
  gn_silu_conv3x3.launches_by_shape = {}
  gn_silu_conv3x3.jvp_launches = 0
  gn_silu_conv3x3.jvp_launches_by_shape = {}


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel_fn():
  fn = load_library(_KERNEL).gn_silu_conv3x3_tf32x3
  fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


@functools.lru_cache(maxsize=None)
def _jvp_kernel_fn():
  fn = load_library(_KERNEL).gn_silu_conv3x3_jvp_tf32x3
  fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn
