"""Fused GroupNorm-apply + SiLU + 3x3 conv (NHWC, forward), for Hopper.

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
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import launch, load_library

_KERNEL = "gn_silu_conv3x3"
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
                sms: int = H100_SMS) -> LaunchPlan:
  """The kernel's grid for one shape: blocks of BM // W whole pixel rows
  (flattened across images) x BN output channels and, where they are
  fewer than the blocks the SMs hold at once (BLOCKS_PER_SM each, fewer
  where the shared memory does not fit them), split-K over the C / BK
  chunks so that about that many blocks run, in one wave. Split s takes
  chunks [s * chunks // S, (s + 1) * chunks // S), all 9 taps of each."""
  cp, op = _padded(c, o)
  rows = BM // w
  tiles = -(-(n * h) // rows) * (op // BN)
  chunks = cp // BK
  slots = min(n, -(-(rows + 2) // h) + 1)
  hp = (rows + 2) * (w + 2)  # halo pixels
  smem = 4 * (2 * hp * BK + 2 * (hp + 1) * (BK + 4) + 4 * BK * (BN + 8)
              + 2 * cp + 2 * slots * groups + 3 * BM)
  resident = max(1, min(BLOCKS_PER_SM, _SM_SMEM // (smem + 1024)))
  splits = max(1, min(round(resident * sms / tiles), chunks))
  return LaunchPlan(cp, op, n * h * w, rows,
                    (op // BN, -(-(n * h) // rows), splits), chunks, splits,
                    slots, smem)


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


def gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, w, b, groups: int = 32,
                    w_split=None) -> torch.Tensor:
  """``conv3x3(silu((x - mean_g) * rsqrt_g * gamma + beta), SAME) + b``.

  x: [N, H, W, C]; mean/rsqrt: [N, G] per-(sample, group) statistics
  (rsqrt = 1/sqrt(var + eps)); gamma/beta: [C]; w: [3, 3, C, O]; b: [O].
  Returns [N, H, W, O] in x's dtype. A CUDA tensor launches the kernel
  and counts the launch in ``gn_silu_conv3x3.launches`` and, per
  ``(H, W, C, O)``, in ``gn_silu_conv3x3.launches_by_shape``; a CPU tensor
  takes the plain version. Forward only: it refuses inputs that need a
  gradient. ``w_split`` is ``weight_operand(w)`` where the caller keeps it
  per weight value; without it the kernel's call splits ``w`` itself. The
  CPU path does not read it.
  """
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, mean, rsqrt, gamma, beta, w, b)):
    raise RuntimeError("gn_silu_conv3x3 is forward-only: call it under "
                       "torch.no_grad() or torch.inference_mode()")
  if x.device.type == "cpu":
    return gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b, groups)
  if x.device.type != "cuda":
    raise ValueError(f"gn_silu_conv3x3 runs on cuda or cpu, not {x.device}")
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  for name, t in (("x", x), ("w", w), ("b", b), ("gamma", gamma),
                  ("beta", beta)):
    if t.dtype != torch.float32:
      raise NotImplementedError(
          f"gn_silu_conv3x3 kernel takes float32 only ({name} is "
          f"{t.dtype}); bfloat16 is listed in ROADMAP.md Queue 2")
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  n, h, wd, c = x.shape
  o = w.shape[-1]
  if c % 4 or x.data_ptr() % 16:
    raise NotImplementedError(f"the gn_silu_conv3x3 kernel copies 16-byte "
                              f"chunks: C = {c} must be a multiple of 4 and "
                              f"x 16-byte aligned")
  if wd > BM:
    raise NotImplementedError(f"the gn_silu_conv3x3 kernel takes rows of "
                              f"at most {BM} pixels, not W = {wd}")
  plan = launch_plan(n, h, wd, c, o, groups, _sms(x.device))
  if plan.smem > _MAX_SMEM:
    raise NotImplementedError(f"gn_silu_conv3x3: a tile of {plan.rows} rows "
                              f"of {wd} pixels, {c} channels and {groups} "
                              f"groups exceeds shared memory")
  if w_split is None:
    w_split = weight_operand(w)
  w_hi, w_lo = w_split
  if (w_hi.shape != (9 * plan.cp, plan.op) or w_lo.shape != w_hi.shape
      or w_hi.device != x.device or w_lo.device != x.device):
    raise ValueError(f"w_split must be two [{9 * plan.cp}, {plan.op}] "
                     f"tensors on {x.device}, from weight_operand(w)")
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
  by_shape = gn_silu_conv3x3.launches_by_shape
  by_shape[(h, wd, c, o)] = by_shape.get((h, wd, c, o), 0) + 1
  return out


def reset_launch_counts() -> None:
  """Set the kernel's launch counts (total and per shape) to zero."""
  gn_silu_conv3x3.launches = 0
  gn_silu_conv3x3.launches_by_shape = {}


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
