"""Fused GroupNorm-apply + SiLU + 3x3 conv (NHWC), for Hopper, in float32
or bfloat16, with its forward-mode derivative.

Counterpart of ``soft_truncation_tpu/ops/pallas/gn_conv.py``. The GroupNorm
statistics (:func:`gn_stats`) stay plain torch ops, as the JAX package
leaves them to XLA; the rest, ``conv3x3(SiLU(x*scale + shift), zero pad) +
b`` with the fold of stats and affine into ``scale, shift``, is one
hand-written CUDA kernel per dtype: an implicit GEMM on the tensor cores,
for f32 inputs in 3xTF32 ``mma.sync`` with split-K over launches
(``csrc/gn_silu_conv3x3.cu``), for bf16 ones in ``wgmma`` with the
activated operand in registers, TMA-fed weights and split-K across a
thread-block cluster (``csrc/gn_silu_conv3x3_bf16.cu``); the f32 tangent
is that design in 3xTF32 ``wgmma`` (``csrc/gn_silu_conv3x3_jvp.cu``). The
normalised slab never reaches device memory.

bfloat16 (``config.tpu.compute_dtype``): x, w and b in bf16, as the JAX
package's fused site casts them, the statistics, gamma and beta in f32.
The fold and SiLU run in f32 and are rounded once to bf16 before the
products (the TPU kernel rounds SiLU to ``w.dtype``), the sums stay f32,
the bias is added in f32 and the output is rounded to bf16 at the store;
the plain versions round at the same places. Any other dtype raises.

:func:`gn_silu_conv3x3` launches the kernel for CUDA tensors and takes the
plain version, :func:`gn_silu_conv3x3_plain`, only for CPU tensors. The
kernels' tiling (:func:`launch_plan`) and weight operands
(:func:`tf32_split`, :func:`weight_operand`) are plain Python here, so the
CPU tests can replay their arithmetic; the f32 tangent's plan is
:func:`_jvp_plan` and its operand :func:`jvp_weight_operand`. The bf16
kernel and the f32 tangent read their operands by TMA through tensor maps
made once per operand (:func:`_tensor_map`).

Forward mode (``torch.func.jvp``, as the likelihood takes the Hutchinson
divergence): with tangents of ``x`` and of the stats (gamma, beta, w and b
held constant), the output's tangent is ``conv3x3(SiLU'(a) * da)``, no
bias (:func:`gn_silu_conv3x3_jvp_plain` writes it out). A kernel computes
it for each dtype (:func:`gn_silu_conv3x3_jvp`: f32 in
``csrc/gn_silu_conv3x3_jvp.cu``, bf16 in the bf16 source's tangent mode),
and the wrapper's ``torch.autograd.Function`` names it as its ``jvp`` rule,
so
under ``torch.func.jvp`` each fused site launches the kernel twice, for
the primal and for the tangent. There is no reverse-mode rule: the
Function's backward refuses, as the JAX package has no VJP for its kernel.
Where no derivative can be asked of the call (serving) the wrapper calls
the kernel directly, without the Function (``ops/_autodiff.py``).

Both modes are also operators, ``soft_truncation::gn_silu_conv3x3`` and
``::gn_silu_conv3x3_jvp`` (``ops/_build.py::define_op``): CPU = the plain
version, CUDA = the launch (:func:`_primal_cuda`, :func:`_jvp_cuda`, which
count it), fake = the output's shape. Every call goes through the
operator, traced (``torch.export``) or eager: on the card's host its
dispatch costs a few microseconds per call over a direct call of the
launch function (``PERF.md``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._autodiff import below_transforms, plain, records_derivatives
from ._build import define_op, launch, load_library, tracing

_KERNEL = "gn_silu_conv3x3"
_BF16_KERNEL = "gn_silu_conv3x3_bf16"
_JVP_KERNEL = "gn_silu_conv3x3_jvp"
_FORWARD_ONLY = ("gn_silu_conv3x3 is forward-only: call it under "
                 "torch.no_grad() or torch.inference_mode()")
# csrc/gn_silu_conv3x3.cu's tile (BM GEMM rows, BN output channels, BK
# channels per chunk) and the blocks an SM holds
BM, BN, BK = 128, 128, 16
BLOCKS_PER_SM = 2
# csrc/gn_silu_conv3x3_bf16.cu's tile: BF16_BM GEMM rows, BF16_BK channels
# per chunk (a 128-byte pixel row), block widths of output channels, the
# most blocks of a cluster along K
BF16_BM, BF16_BK = 64, 64
BF16_BLOCK_N = (64, 128, 256)
BF16_MAX_SPLITS = 8
# csrc/gn_silu_conv3x3_jvp.cu's tile (the f32 tangent): JVP_BM GEMM rows,
# JVP_BK channels per chunk (a 128-byte f32 pixel row), the bf16 kernel's
# block widths and clusters
JVP_BM, JVP_BK = 64, 32
JVP_BLOCK_M = (64, 128)  # GEMM rows per block; 128 with block_n <= 128
# clusters of 1, 2, 4 and 8 of its blocks the H100's 132 SMs hold at once
# (cudaOccupancyMaxActiveClusters: its GPCs leave SMs that clusters of 4 or
# 8 cannot fill), scaled to another SM count
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
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
  the model and the reference the kernel is held against on the card.
  Computed in f32; SiLU is rounded to ``w``'s dtype before the conv and
  the output to ``x``'s, where the kernel rounds (bf16: once each)."""
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  scale, shift = _fold(mean, rsqrt, gamma, beta, groups)
  act = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
  act = F.pad(act.to(w.dtype).float().permute(0, 3, 1, 2),
              (1, 1, 1, 1))  # NCHW, zeros
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
  Written out from that formula, in f32, with ``SiLU'(a) * da`` rounded to
  ``w``'s dtype and the output to ``x``'s (bf16: the tangent of the bf16
  primal chain); the CPU path of the tangent and the reference the tangent
  kernel is held against on the card."""
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
  act = F.pad((s * (1.0 + a * (1.0 - s)) * da).to(w.dtype).float()
              .permute(0, 3, 1, 2), (1, 1, 1, 1))
  out = F.conv2d(act, w.float().permute(3, 2, 0, 1))
  return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


class LaunchPlan(NamedTuple):
  """How a kernel tiles one (N, H, W, C, O): see :func:`launch_plan`."""
  cp: int       # C padded to a multiple of the chunk (BK; bf16: BF16_BK;
  #               the f32 tangent: JVP_BK)
  op: int       # O padded to a multiple of the block's output channels
  m: int        # N*H*W, the GEMM's rows
  rows: int     # pixel rows per block (f32: BM // W, its GEMM rows rows * W)
  grid: tuple   # (O tiles, row tiles, splits)
  chunks: int   # cp / chunk, each 9 K steps (one per tap)
  splits: int
  slots: int    # f32: images the block's rows + 2 halo rows can touch
  smem: int     # dynamic shared memory, bytes
  cols: int = 0       # bf16 and the f32 tangent: pixels of a row per
  #                     block, min(W, 64)
  block_n: int = BN   # output channels per block
  stages: int = 2     # the weights' ring
  raws: int = 1       # bf16 and the f32 tangent: raw halo tiles (2: chunk
  #                     1 loads beside 0)
  block_m: int = 0    # the f32 tangent: GEMM rows per block (JVP_BLOCK_M)


def jvp_smem_bytes(hp: int, block_n: int, stages: int, raws: int) -> int:
  """The f32 tangent's dynamic shared memory (``csrc/
  gn_silu_conv3x3_jvp.cu``'s ``smem_bytes``) for ``hp`` halo pixels: 1 KB
  to align the base, the weights' ring of ``stages`` x (hi, lo) x
  ``block_n`` rows of 128 bytes, two activated tiles of hp + 1 such rows,
  ``raws`` x (x, dx) raw halo tiles of hp rows, and the mbarriers."""
  row = 4 * JVP_BK
  return (1024 + stages * 2 * block_n * row + 2 * (hp + 1) * row
          + raws * 2 * hp * row + 8 * (2 * stages + 4))


def smem_bytes(hp: int, streams: int, *, cp: int = 0, slots: int = 0,
               groups: int = 0, bf16: bool = False, block_n: int = BN,
               stages: int = 2, raws: int = 1) -> int:
  """A kernel's dynamic shared memory for ``hp`` halo pixels and
  ``streams`` raw halo tiles (2 in the bf16 tangent mode: x and its
  tangent). f32 (``csrc/gn_silu_conv3x3.cu``'s ``smem_bytes``, the primal;
  ``streams`` 1): the raw halo ring,
  the activated tile (tf32 hi and lo), the B ring (hi and lo [BK][BN +
  8]), then gamma, beta (``cp`` each), the stats (``slots`` x ``groups``)
  and the row offsets in 4-byte words. bf16 (``csrc/
  gn_silu_conv3x3_bf16.cu``'s): 1 KB to align the base, the weights' ring
  of ``stages`` x ``block_n`` rows of 128 bytes, two activated tiles of hp
  + 1 such rows, ``raws`` x ``streams`` raw halo tiles of hp rows, and the
  mbarriers."""
  if bf16:
    row = 2 * BF16_BK
    return (1024 + stages * block_n * row + 2 * (hp + 1) * row
            + raws * streams * hp * row + 8 * (2 * stages + 4))
  tiles = 4 * (2 * streams * hp * BK + 2 * (hp + 1) * (BK + 4)
               + 4 * BK * (BN + 8))
  return tiles + 4 * (2 * cp + 2 * streams * slots * groups + 3 * BM)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, c: int, o: int, groups: int,
                sms: int = H100_SMS, tangent: bool = False,
                bf16: bool = False) -> LaunchPlan:
  """The kernel's grid for one shape (``bf16``: :func:`_bf16_plan`; the
  f32 ``tangent``: :func:`_jvp_plan`).

  The f32 primal: blocks of BM // W whole pixel rows (flattened across
  images) x BN output channels and, where they are fewer than the blocks
  the SMs hold at once (BLOCKS_PER_SM each, fewer where the shared memory
  does not fit them), split-K over the C / BK chunks so that about that
  many blocks run, in one wave; a second kernel sums the splits. Split s
  takes chunks [s * chunks // S, (s + 1) * chunks // S), all 9 taps of
  each."""
  if bf16:
    return _bf16_plan(n, h, w, c, o, sms, tangent)
  if tangent:
    return _jvp_plan(n, h, w, c, o, sms)
  cp, op = _padded(c, o)
  rows = BM // w
  tiles = -(-(n * h) // rows) * (op // BN)
  chunks = cp // BK
  slots = min(n, -(-(rows + 2) // h) + 1)
  hp = (rows + 2) * (w + 2)  # halo pixels
  smem = smem_bytes(hp, 1, cp=cp, slots=slots, groups=groups)
  resident = max(1, min(BLOCKS_PER_SM, _SM_SMEM // (smem + 1024)))
  splits = max(1, min(round(resident * sms / tiles), chunks))
  return LaunchPlan(cp, op, n * h * w, rows,
                    (op // BN, -(-(n * h) // rows), splits), chunks, splits,
                    slots, smem)


def _cluster_splits(tiles: int, chunks: int, sms: int) -> int:
  """The cluster along K of the bf16 kernel and the f32 tangent: 1, 2, 4
  or 8 blocks (at most ``chunks``), doubled while the blocks still fit one
  wave (one block per SM, and no more clusters than the card holds at
  once: H100_CLUSTERS)."""
  splits = 1
  while (2 * splits <= min(BF16_MAX_SPLITS, chunks)
         and 2 * splits * tiles <= sms
         and tiles <= H100_CLUSTERS[2 * splits] * sms // H100_SMS):
    splits *= 2
  return splits


# the f32 tangent's time per block in us (H100, 700 W), as fitted to the
# card's times of every (rows, columns) shape at the flagship's 13 tangent
# site shapes (PERF.md): a fixed part (launch, the first chunk, the
# epilogue), then per 32-channel chunk one part per halo pixel activated,
# one per output column (the weights' bytes) and one per product (rows x
# columns)
JVP_COST_US = (7.86, 0.0245, 0.0211, 0.000213)


def _jvp_plan(n: int, h: int, w: int, c: int, o: int, sms: int,
              block_m: int = 0, block_n: int = 0) -> LaunchPlan:
  """The f32 tangent's grid (``csrc/gn_silu_conv3x3_jvp.cu``), the bf16
  kernel's tiling in f32: blocks of ``block_m`` GEMM rows (JVP_BLOCK_M), R
  = block_m // TW pixel rows of TW = min(W, 64) pixels (a row's segments
  of TW beyond), by ``block_n`` output channels (the least of BF16_BLOCK_N
  that holds O, 256 past it, or a half or a quarter of that; 128 rows
  take at most 128 channels), and a cluster along K as
  :func:`_cluster_splits` sizes it, over the C / JVP_BK chunks. Of the
  shapes whose tiles fit shared memory it takes the one whose blocks
  (tiles x cluster, in waves of ``sms``) take the least time by
  JVP_COST_US (ties to more rows, then to the wider); ``block_m`` and
  ``block_n`` force a shape. At batch 8 the 32x32 and 8x8 sites take 128
  x 128, the 16x16 ones with O = 256 64 x 128, the 4x4 ones 64 x 64. The
  shared memory
  takes, in this order of preference, 4 or 3 stages of the weights' ring
  with a second raw tile, 4 or 3 with one, then 2 with two or one (the
  partial tile must fit the ring: 128 rows need 3 stages at 128
  channels). Tiles of 64 x 64 fit any shape (at most 3 x 66 halo
  pixels), so a plan always fits."""
  cp, op = _jvp_padded(c, o)
  chunks = cp // JVP_BK
  cols = min(w, JVP_BM)
  nominal = min(op, BF16_BLOCK_N[-1])
  best = None
  for bm in (block_m,) if block_m else JVP_BLOCK_M[::-1]:
    rows = bm // cols
    grid_m = -(-(n * h) // rows) * -(-w // cols)
    hp = (rows + 2) * (cols + 2)
    for bn in (block_n,) if block_n else (nominal, nominal // 2,
                                          nominal // 4):
      if bn < BF16_BLOCK_N[0] or op % bn or (bm > JVP_BM and bn > 128):
        continue
      fitting = [(stages, raws, size)
                 for stages, raws in ((4, 2), (3, 2), (4, 1), (3, 1), (2, 2),
                                      (2, 1))
                 for size in [jvp_smem_bytes(hp, bn, stages, raws)]
                 if size <= _MAX_SMEM
                 and bm * (bn + 8) * 4 <= stages * 2 * bn * 4 * JVP_BK]
      if not fitting:
        continue
      tiles = grid_m * (op // bn)
      splits = _cluster_splits(tiles, chunks, sms)
      fixed, per_pixel, per_column, per_product = JVP_COST_US
      cost = -(-tiles * splits // sms) * (fixed + -(-chunks // splits) * (
          per_pixel * hp + per_column * bn + per_product * bm * bn))
      if best is None or cost < best[0]:
        best = (cost, LaunchPlan(cp, op, n * h * w, rows,
                                 (op // bn, grid_m, splits), chunks, splits,
                                 0, fitting[0][2], cols, bn, *fitting[0][:2],
                                 bm))
  return best[1]


def _bf16_plan(n: int, h: int, w: int, c: int, o: int, sms: int,
               tangent: bool) -> LaunchPlan:
  """The bf16 kernel's grid: blocks of BF16_BM GEMM rows, R = BF16_BM //
  TW pixel rows of TW = min(W, BF16_BM) pixels (a row's segments of TW
  beyond), by ``block_n`` output channels, the least of BF16_BLOCK_N
  that holds O (256 past it: x is activated once per block up to O =
  256); and, where those blocks leave the SMs mostly idle, a cluster of S
  blocks along K (1, 2, 4 or 8, at most the C / BF16_BK chunks), doubled
  while the blocks still fit one wave (one block per SM, and no more
  clusters than the card holds at once: H100_CLUSTERS). Cluster block s
  takes chunks [s * chunks // S, (s + 1) * chunks // S) and stores rows
  [s * BF16_BM // S, (s + 1) * BF16_BM // S) of the sum. The shared memory
  takes, in this order of preference, 4 stages of the weights' ring and a
  second raw tile, 3 stages and a second raw tile, then 4 or 3 stages and
  one raw tile."""
  cols = min(w, BF16_BM)
  rows = BF16_BM // cols
  cp, op = _bf16_padded(c, o)
  block_n = min(op, BF16_BLOCK_N[-1])
  chunks = cp // BF16_BK
  grid_m = -(-(n * h) // rows) * -(-w // cols)
  tiles = grid_m * (op // block_n)
  splits = _cluster_splits(tiles, chunks, sms)
  hp = (rows + 2) * (cols + 2)
  streams = 2 if tangent else 1
  smem, stages, raws = next(
      (size, stages, raws) for stages, raws in ((4, 2), (3, 2), (4, 1), (3, 1))
      for size in [smem_bytes(hp, streams, bf16=True, block_n=block_n,
                              stages=stages, raws=raws)]
      if size <= _MAX_SMEM)
  return LaunchPlan(cp, op, n * h * w, rows, (op // block_n, grid_m, splits),
                    chunks, splits, 0, smem, cols, block_n, stages, raws)


def fits(n: int, h: int, w: int, c: int, o: int, groups: int) -> bool:
  """Whether the kernels take this shape in both modes: rows of at most BM
  pixels, and each mode's tile within a block's shared memory. The
  models route any other site to the plain chain, decided per shape. The
  answer holds for both dtypes: the bf16 kernel takes the same C (a
  multiple of 4) and W, and its tiles, at most 3 x 66 halo pixels of 64
  channels beside 3 stages of 256 x 64 weights, fit wherever W <= BM, so
  a site's route does not depend on the compute dtype; the f32 tangent's
  plan fits any shape (:func:`_jvp_plan`)."""
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
  """C and O padded to the f32 kernel's chunk (BK) and tile (BN) widths."""
  return -(-c // BK) * BK, -(-o // BN) * BN


def _jvp_padded(c: int, o: int):
  """C and O padded to the f32 tangent's chunk (JVP_BK) and to a multiple
  of its nominal block (as :func:`_bf16_padded`), which its smaller block
  divides too."""
  return -(-c // JVP_BK) * JVP_BK, _bf16_padded(c, o)[1]


def _bf16_padded(c: int, o: int):
  """C and O padded to the bf16 kernel's chunk (BF16_BK) and to a multiple
  of its block's output channels (the least of BF16_BLOCK_N that holds O,
  the largest past it)."""
  block_n = next((b for b in BF16_BLOCK_N if o <= b), BF16_BLOCK_N[-1])
  return -(-c // BF16_BK) * BF16_BK, -(-o // block_n) * block_n


def weight_operand(w: torch.Tensor):
  """The HWIO weights as the kernel reads them: for f32 ``w``, [9*Cp, Op]
  (tap-major rows of Cp channels, zero padding) split into TF32
  ``(hi, lo)``; for bf16 ``w``, the one tensor ``(wt,)``, the same values
  as bf16 [Op, 9*Cp] (output channel major, K contiguous; Cp and Op the
  bf16 kernel's, :func:`_bf16_padded`), the rows its TMA boxes read. A
  caller that launches the kernel on one weight value many times computes
  this once and passes it as ``w_split`` (``DDPMConv.weight_operand``); the
  bf16 kernel's tensor map of it is made once per operand too
  (:func:`_tensor_map`)."""
  c, o = w.shape[2], w.shape[3]
  dtype = _kernel_dtype(w.dtype, "w")
  cp, op = (_bf16_padded if dtype == torch.bfloat16 else _padded)(c, o)
  wp = w.new_zeros((9, cp, op), dtype=dtype)
  wp[:, :c, :o] = w.reshape(9, c, o)
  if wp.dtype == torch.bfloat16:
    return (wp.reshape(9 * cp, op).t().contiguous(),)
  return tf32_split(wp.reshape(9 * cp, op))


def jvp_weight_operand(w: torch.Tensor):
  """The HWIO weights as the tangent's kernel reads them: for f32 ``w``,
  [Op, 9*Cp] (output channel major, K = tap-major rows of Cp channels
  contiguous, zero padding; Cp and Op :func:`_jvp_padded`'s) split into
  TF32 ``(hi, lo)``, the rows the f32 tangent's TMA boxes read; for bf16
  ``w`` the primal's operand, :func:`weight_operand` (the bf16 source's
  tangent mode reads the same). A caller that differentiates one weight
  value many times computes this once and passes it to
  :func:`gn_silu_conv3x3_jvp` as ``w_split`` (``DDPMConv.
  jvp_weight_operand``); the tensor maps of it are made once per operand
  too (:func:`_tensor_map`)."""
  if _kernel_dtype(w.dtype, "w") == torch.bfloat16:
    return weight_operand(w)
  c, o = w.shape[2], w.shape[3]
  cp, op = _jvp_padded(c, o)
  wp = w.new_zeros((9, cp, op))
  wp[:, :c, :o] = w.reshape(9, c, o)
  return tuple(t.t().contiguous() for t in tf32_split(wp.reshape(9 * cp, op)))


def _kernel_dtype(dtype: torch.dtype, name: str) -> torch.dtype:
  """``dtype`` if the kernel has a mode for it (f32, bf16), else raise."""
  if dtype not in (torch.float32, torch.bfloat16):
    raise NotImplementedError(f"the gn_silu_conv3x3 kernel takes float32 or "
                              f"bfloat16, not {dtype} ({name})")
  return dtype


def _kernel_operands(name, x, tensors, w, groups, w_split, tangent):
  """Check what the kernel takes (f32 or bf16 x and weights, f32 affine;
  contiguous; 4-channel chunks of x; W; shared memory) and return its
  launch plan and weight operand (``w_lo`` None in bf16): for the f32
  ``tangent`` :func:`jvp_weight_operand`'s, else :func:`weight_operand`'s."""
  dtype = _kernel_dtype(x.dtype, "x")
  for tname, t in tensors:
    want = torch.float32 if tname in ("gamma", "beta") else dtype
    if t.dtype != want:
      raise NotImplementedError(f"the {name} kernel's {dtype} mode takes "
                                f"{tname} in {want}, not {t.dtype}")
    if not t.is_contiguous():
      raise ValueError(f"{tname} must be contiguous")
  n, h, wd, c = x.shape
  o = w.shape[-1]
  if c % 4 or any(t.data_ptr() % (4 * t.element_size())
                  for tname, t in tensors if tname in ("x", "dx")):
    raise NotImplementedError(f"the {name} kernel copies 4-channel chunks: "
                              f"C = {c} must be a multiple of 4 and x (and "
                              f"dx) aligned to 4 elements")
  if wd > BM:
    raise NotImplementedError(f"the {name} kernel takes rows of at most "
                              f"{BM} pixels, not W = {wd}")
  bf16 = dtype == torch.bfloat16
  plan = launch_plan(n, h, wd, c, o, groups, _sms(x.device), tangent, bf16)
  if plan.smem > _MAX_SMEM:
    raise NotImplementedError(f"{name}: a tile of {plan.rows} rows of {wd} "
                              f"pixels, {c} channels and {groups} groups "
                              f"exceeds shared memory")
  make = jvp_weight_operand if tangent else weight_operand
  if w_split is None:
    w_split = make(w)
  k_major = bf16 or tangent
  shape = (plan.op, 9 * plan.cp) if k_major else (9 * plan.cp, plan.op)
  if (len(w_split) != (1 if bf16 else 2)
      or any(t.shape != shape or t.dtype != dtype or t.device != x.device
             for t in w_split)):
    raise ValueError(f"w_split must be {'one' if bf16 else 'two'} {dtype} "
                     f"{list(shape)} tensor(s) on {x.device}, from "
                     f"{make.__name__}(w)")
  return plan, w_split[0], None if bf16 else w_split[1]


def _count(counts: dict, key) -> None:
  counts[key] = counts.get(key, 0) + 1


def _primal_cuda(x, mean, rsqrt, gamma, beta, w, b, groups: int, w_split):
  """One launch of the kernel on CUDA tensors, counted: the operator's
  CUDA implementation."""
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  plan, w_hi, w_lo = _kernel_operands(
      "gn_silu_conv3x3", x, (("x", x), ("w", w), ("b", b), ("gamma", gamma),
                             ("beta", beta)), w, groups, w_split, False)
  n, h, wd, c = x.shape
  o = w.shape[-1]
  mean = mean.float().contiguous()
  rsqrt = rsqrt.float().contiguous()
  out = x.new_empty((n, h, wd, o))
  bf16 = x.dtype == torch.bfloat16
  if bf16:
    err = launch(_bf16_kernel_fn(False), x.device, x.data_ptr(),
                 mean.data_ptr(), rsqrt.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), _tensor_map_of(w_hi, plan), b.data_ptr(),
                 out.data_ptr(), *_plan_ints(n, h, wd, c, o, groups, plan))
  else:
    ws = _workspace(x, plan, o)
    err = launch(_kernel_fn(), x.device, x.data_ptr(), mean.data_ptr(),
                 rsqrt.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 w_hi.data_ptr(), w_lo.data_ptr(), b.data_ptr(),
                 out.data_ptr(), _ptr(ws), n, h, wd, c, o, groups, plan.cp,
                 plan.op, plan.rows, plan.splits, plan.slots)
  if err != 0:
    raise RuntimeError(f"gn_silu_conv3x3 launch failed: cudaError {err}")
  gn_silu_conv3x3.launches += 1
  gn_silu_conv3x3.bf16_launches += bf16
  _count(gn_silu_conv3x3.launches_by_shape, (h, wd, c, o))
  return out


def _plan_ints(n, h, w, c, o, groups, plan: LaunchPlan):
  """The int arguments after the tensors of the entry points planned in
  64-channel (bf16) or 32-channel (the f32 tangent) chunks."""
  return (n, h, w, c, o, groups, plan.cp, plan.op, plan.rows, plan.cols,
          plan.block_n, plan.splits, plan.stages, plan.raws)


def _workspace(x, plan: LaunchPlan, o: int):
  """The f32 kernel's split-K partial sums' workspace, or None without
  split-K."""
  if plan.splits == 1:
    return None
  return x.new_empty((plan.splits, plan.m, o), dtype=torch.float32)


def _ptr(t) -> int:
  return 0 if t is None else t.data_ptr()


def _split_pair(w_hi, w_lo):
  """The operator's two optional weight tensors as ``w_split``: (hi, lo)
  in f32, (wt,) in bf16 (``w_lo`` None)."""
  if w_hi is None:
    return None
  return (w_hi,) if w_lo is None else (w_hi, w_lo)


def _split_args(w_split):
  """``w_split`` as the operator's ``(w_hi, w_lo)``."""
  if w_split is None:
    return None, None
  return tuple(w_split) + (None,) * (2 - len(w_split))


def _fake_out(x, w):
  n, h, wd, _ = x.shape
  return x.new_empty((n, h, wd, w.shape[-1]))


def _op_fake(x, mean, rsqrt, gamma, beta, w, b, groups, w_hi, w_lo):
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  return _fake_out(x, w)


_OP = define_op(
    "gn_silu_conv3x3",
    "(Tensor x, Tensor mean, Tensor rsqrt, Tensor gamma, Tensor beta, "
    "Tensor w, Tensor b, int groups, Tensor? w_hi, Tensor? w_lo) -> Tensor",
    cpu=lambda x, mean, rsqrt, gamma, beta, w, b, groups, w_hi, w_lo:
    gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b, groups),
    cuda=lambda x, mean, rsqrt, gamma, beta, w, b, groups, w_hi, w_lo:
    _primal_cuda(x, mean, rsqrt, gamma, beta, w, b, groups,
                 _split_pair(w_hi, w_lo)),
    fake=_op_fake)


def _on_cpu_or_cuda(x) -> None:
  if x.device.type not in ("cpu", "cuda") and not tracing():
    raise ValueError(f"gn_silu_conv3x3 runs on cuda or cpu, not {x.device}")


def _primal(x, mean, rsqrt, gamma, beta, w, b, groups: int, w_split):
  """The operator: the plain version for a CPU tensor, one launch for a
  CUDA tensor, an opaque node while tracing."""
  _on_cpu_or_cuda(x)
  return _OP(x, mean, rsqrt, gamma, beta, w, b, groups, *_split_args(w_split))


def _jvp_cuda(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w,
              groups: int, w_split):
  """One launch of the tangent mode on CUDA tensors, counted: the
  operator's CUDA implementation."""
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
  bf16 = x.dtype == torch.bfloat16
  if bf16:
    err = launch(_bf16_kernel_fn(True), x.device, x.data_ptr(),
                 dx.data_ptr(), *(t.data_ptr() for t in stats),
                 gamma.data_ptr(), beta.data_ptr(),
                 _tensor_map_of(w_hi, plan), out.data_ptr(),
                 *_plan_ints(n, h, wd, c, o, groups, plan))
  else:
    err = launch(_jvp_kernel_fn(), x.device, x.data_ptr(), dx.data_ptr(),
                 *(t.data_ptr() for t in stats), gamma.data_ptr(),
                 beta.data_ptr(), _tensor_map_of(w_hi, plan),
                 _tensor_map_of(w_lo, plan), out.data_ptr(),
                 *_plan_ints(n, h, wd, c, o, groups, plan), plan.block_m)
  if err != 0:
    raise RuntimeError(f"gn_silu_conv3x3 tangent launch failed: cudaError "
                       f"{err}")
  gn_silu_conv3x3.jvp_launches += 1
  gn_silu_conv3x3.bf16_jvp_launches += bf16
  _count(gn_silu_conv3x3.jvp_launches_by_shape, (h, wd, c, o))
  return out


def _jvp_op_fake(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w, groups,
                 w_hi, w_lo):
  _check(x, mean, rsqrt, gamma, beta, w, w.new_empty(w.shape[-1]), groups)
  _check_tangents(x, dx, dmean, drsqrt, groups)
  return _fake_out(x, w)


_JVP_OP = define_op(
    "gn_silu_conv3x3_jvp",
    "(Tensor x, Tensor dx, Tensor mean, Tensor dmean, Tensor rsqrt, "
    "Tensor drsqrt, Tensor gamma, Tensor beta, Tensor w, int groups, "
    "Tensor? w_hi, Tensor? w_lo) -> Tensor",
    cpu=lambda x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w, groups,
    w_hi, w_lo: gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt, drsqrt,
                                          gamma, beta, w, groups),
    cuda=lambda x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w, groups,
    w_hi, w_lo: _jvp_cuda(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w,
                          groups, _split_pair(w_hi, w_lo)),
    fake=_jvp_op_fake)


def gn_silu_conv3x3_jvp(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w,
                        groups: int = 32, w_split=None) -> torch.Tensor:
  """The tangent of :func:`gn_silu_conv3x3` (see
  :func:`gn_silu_conv3x3_jvp_plain`): a CUDA tensor launches the kernel in
  its tangent mode and counts the launch in
  ``gn_silu_conv3x3.jvp_launches`` (a bf16 one also in
  ``.bf16_jvp_launches``) and, per ``(H, W, C, O)``, in
  ``gn_silu_conv3x3.jvp_launches_by_shape``; a CPU tensor takes the plain
  version (both through the operator
  ``soft_truncation::gn_silu_conv3x3_jvp``). ``w_split`` is
  ``jvp_weight_operand(w)`` where the caller keeps it per weight value
  (the tangent's operand: in bf16 the primal's)."""
  _on_cpu_or_cuda(x)
  return _JVP_OP(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, w, groups,
                 *_split_args(w_split))


class _GnSiluConv3x3(torch.autograd.Function):
  """The fused call with a forward-mode rule (its tangent kernel) and a
  backward that refuses (module docstring)."""

  @staticmethod
  def forward(x, mean, rsqrt, gamma, beta, w, b, groups, w_split,
              jvp_split):
    return _primal(x, mean, rsqrt, gamma, beta, w, b, groups, w_split)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, mean, rsqrt, gamma, beta, w, _, groups, _, jvp_split = inputs
    ctx.set_materialize_grads(False)  # a constant's tangent stays None
    ctx.save_for_forward(x, mean, rsqrt, gamma, beta, w)
    ctx.groups, ctx.jvp_split = groups, jvp_split

  @staticmethod
  def jvp(ctx, dx, dmean, drsqrt, dgamma, dbeta, dw, db, *_):
    if any(t is not None for t in (dgamma, dbeta, dw, db)):
      raise NotImplementedError("gn_silu_conv3x3's jvp holds gamma, beta, w "
                                "and b constant")
    x, mean, rsqrt, gamma, beta, w = map(plain, ctx.saved_tensors)
    tangents = [None if t is None else plain(t) for t in (dx, dmean, drsqrt)]
    w_split = ctx.jvp_split() if callable(ctx.jvp_split) else ctx.jvp_split
    w_split = w_split and tuple(map(plain, w_split))
    with below_transforms():
      dx, dmean, drsqrt = (torch.zeros_like(p) if t is None else t
                           for t, p in zip(tangents, (x, mean, rsqrt)))
      return gn_silu_conv3x3_jvp(x, dx.contiguous(), mean, dmean, rsqrt,
                                 drsqrt, gamma, beta, w, ctx.groups, w_split)

  @staticmethod
  def backward(ctx, *grads):
    raise RuntimeError(_FORWARD_ONLY)


def gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, w, b, groups: int = 32,
                    w_split=None, jvp_split=None) -> torch.Tensor:
  """``conv3x3(silu((x - mean_g) * rsqrt_g * gamma + beta), SAME) + b``.

  x: [N, H, W, C]; mean/rsqrt: [N, G] per-(sample, group) statistics
  (rsqrt = 1/sqrt(var + eps)); gamma/beta: [C]; w: [3, 3, C, O]; b: [O].
  x, w and b in f32 or all three in bf16 (mean, rsqrt, gamma and beta f32).
  Returns [N, H, W, O] in x's dtype. A CUDA tensor launches the kernel
  and counts the launch in ``gn_silu_conv3x3.launches`` (a bf16 one also
  in ``.bf16_launches``) and, per ``(H, W, C, O)``, in
  ``gn_silu_conv3x3.launches_by_shape``; a CPU tensor
  takes the plain version (both through the operator
  ``soft_truncation::gn_silu_conv3x3``, which ``torch.export`` keeps as one
  node). Forward and forward mode only: under
  ``torch.func.jvp`` the tangent is :func:`gn_silu_conv3x3_jvp`, and a
  backward through the call raises. ``w_split`` is ``weight_operand(w)``
  where the caller keeps it per weight value, and ``jvp_split``
  ``jvp_weight_operand(w)`` (or a callable that returns it, called at the
  first tangent), the tangent's; without them each kernel's call splits
  ``w`` itself. The CPU path reads neither.
  """
  if records_derivatives():
    return _GnSiluConv3x3.apply(x, mean, rsqrt, gamma, beta, w, b, groups,
                                w_split, jvp_split)
  return _primal(x, mean, rsqrt, gamma, beta, w, b, groups, w_split)


def reset_launch_counts() -> None:
  """Set the kernel's launch counts, primal and tangent (total, bf16 and
  per shape), to zero."""
  gn_silu_conv3x3.launches = 0
  gn_silu_conv3x3.bf16_launches = 0
  gn_silu_conv3x3.launches_by_shape = {}
  gn_silu_conv3x3.jvp_launches = 0
  gn_silu_conv3x3.bf16_jvp_launches = 0
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
  fn = load_library(_JVP_KERNEL).gn_silu_conv3x3_jvp_tf32x3
  fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 15
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


@functools.lru_cache(maxsize=None)
def _bf16_kernel_fn(tangent: bool):
  lib = load_library(_BF16_KERNEL)
  if tangent:
    fn, pointers = lib.gn_silu_conv3x3_jvp_bf16, 10
  else:
    fn, pointers = lib.gn_silu_conv3x3_bf16, 8
  fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 14
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def _tensor_map_of(wt: torch.Tensor, plan: LaunchPlan) -> int:
  """The address of the tensor map of weight operand ``wt`` (bf16: the
  bf16 kernel's; f32: one half of the f32 tangent's) for boxes of
  ``plan.block_n`` rows, made at its first launch."""
  return ctypes.addressof(_tensor_map(wt.data_ptr(), wt.shape[0],
                                      wt.shape[1], plan.block_n,
                                      wt.dtype == torch.bfloat16))


@functools.lru_cache(maxsize=4096)
def _tensor_map(ptr: int, rows: int, k: int, block_n: int, bf16: bool):
  """The host copy of the TMA tensor map of the K-major weight operand at
  ``ptr`` ([rows, k], k contiguous; bf16 for the bf16 kernel, else f32
  for the f32 tangent), for boxes of 128 bytes of K by ``block_n`` rows:
  made once per operand (the map holds its address and shape, nothing of
  its values, so a key of those stays right for any tensor that reuses
  them). The entry binds the device's primary context where the calling
  thread has none."""
  lib = load_library(_BF16_KERNEL if bf16 else _JVP_KERNEL)
  prefix = "gn_silu_conv3x3_bf16" if bf16 else "gn_silu_conv3x3_jvp"
  buf = ctypes.create_string_buffer(
      getattr(lib, f"{prefix}_tensor_map_bytes")())
  fn = getattr(lib, f"{prefix}_tensor_map")
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p]
  fn.restype = ctypes.c_int
  err = fn(ptr, rows, k, block_n, ctypes.addressof(buf))
  if err != 0:
    raise RuntimeError(f"{prefix}: cuTensorMapEncodeTiled failed ({err})")
  return buf
