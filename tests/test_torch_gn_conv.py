"""The port's fused GroupNorm->SiLU->conv3x3 (soft_truncation_tpu_torch/ops/
gn_conv.py) against the JAX package's plain chain, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
gn_silu_conv3x3_plain there. Here the plain version, which the CPU path of
the port takes, is held against the JAX reference (gn_stats +
gn_silu_conv3x3_reference; not interpret-mode Pallas, which deadlocks on
this suite's CPU, see test_gn_conv_fused.py), in f32 at rtol=atol=1e-5:
the same f32 arithmetic summed in another order over K <= 9*128 terms.
A numpy replay of the kernel's arithmetic (its tiles, A-tile rows, K order,
split-K partition and 3xTF32 products) is held to the same reference and
bar, which a 1xTF32 replay fails.

Forward mode: gn_silu_conv3x3_jvp_plain (the tangent, written out) is held
against torch.func.jvp of the plain chain and jax.jvp of the JAX reference
at the same bar, and the wrapper's Function (torch.func.jvp, forward_ad
dual tensors) against it. The f32 tangent's kernel (csrc/
gn_silu_conv3x3_jvp.cu: the bf16 kernel's 64-row tiles, halo tile and
cluster split-K over 32-channel chunks, 3xTF32 wgmma): a numpy replay of
its tiles, taps, cluster ranks and products (the activated tangent split
into TF32 hi and lo against the weights' hi and lo) is held against
jax.jvp of the JAX reference at the f32 bar, which a 1xTF32 replay fails;
its plan fits shared memory and takes every chunk once at every site. On
the card the tangent kernel is held against the plain version by
test_tangent_kernel_matches_plain_on_card (marked ``gpu``),
tests/test_torch_gn_conv_gpu.py and chip_smoke.py.

The bf16 kernel (csrc/gn_silu_conv3x3_bf16.cu: 64-row tiles of whole pixel
rows or row segments, a halo tile per 64-channel chunk with a zero row,
split-K across a cluster): bf16_tile replays its per-tap row addresses and
is held against an im2col of the zero-padded image; a numpy replay of its
chunks, cluster ranks and rank-order sum is held against the plain version
at a ragged shape; its launch plan takes every chunk and output row once
and fits shared memory at every published site shape. Both bf16 entries
are held on the card by test_bf16_kernels_match_plain_on_card (``gpu``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.ops.pallas import gn_conv as jax_gn_conv
from soft_truncation_tpu_torch.ops import gn_conv

CASES = [(2, 8, 8, 16, 16, 4), (2, 8, 8, 32, 48, 8), (1, 32, 32, 128, 128, 32)]


def _inputs(n, h, w, c, o, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((n, h, w, c)) * 2.0).astype(np.float32)
  gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
  beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
  wgt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
  b = rng.standard_normal(o).astype(np.float32)
  return x, gamma, beta, wgt, b


@pytest.mark.parametrize("n,h,w,c,o,groups", CASES)
def test_plain_matches_jax_reference(n, h, w, c, o, groups):
  x, gamma, beta, wgt, b = _inputs(n, h, w, c, o)
  want = jax_gn_conv.gn_silu_conv3x3_reference(
      jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
      jnp.asarray(wgt), jnp.asarray(b), groups)
  jmean, jrsqrt = jax_gn_conv.gn_stats(jnp.asarray(x), groups)

  tx = torch.from_numpy(x)
  mean, rsqrt = gn_conv.gn_stats(tx, groups)
  np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(rsqrt.numpy(), np.asarray(jrsqrt), rtol=1e-5,
                             atol=1e-5)
  got = gn_conv.gn_silu_conv3x3_plain(
      tx, mean, rsqrt, torch.from_numpy(gamma), torch.from_numpy(beta),
      torch.from_numpy(wgt), torch.from_numpy(b), groups)
  assert got.shape == (n, h, w, o) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


def split_chunks(plan, split):
  """The channel chunks of one split, as csrc/gn_silu_conv3x3.cu takes
  them: split s takes [s * chunks // S, (s + 1) * chunks // S)."""
  return range(split * plan.chunks // plan.splits,
               (split + 1) * plan.chunks // plan.splits)


def tile_rows(plan, tile, n, h, w, tap):
  """The kernel's A rows for tap ``tap`` (dy, dx = divmod(tap, 3)) in row
  tile ``tile``: GEMM row m is pixel tile * rows * W + m of the flattened
  N*H*W; it reads the flat index of that pixel's neighbour (n, y + dy - 1,
  x + dx - 1), or -1 where the kernel reads zeros (a tap outside the
  image, or a row past the tile or past N*H*W)."""
  m = np.arange(gn_conv.BM)
  pix = tile * plan.rows * w + m
  img, rem = np.divmod(pix, h * w)
  sy = rem // w + tap // 3 - 1
  sx = rem % w + tap % 3 - 1
  ok = ((m < plan.rows * w) & (pix < n * h * w) & (sy >= 0) & (sy < h)
        & (sx >= 0) & (sx < w))
  return np.where(ok, (img * h + sy) * w + sx, -1)


def _replay_kernel(x, gamma, beta, wgt, b, groups, passes):
  """numpy replay of csrc/gn_silu_conv3x3.cu: per row tile and split, the
  chunks of the split in order and the 9 taps of each, each adding the
  TF32 products of the activated A rows (tile_rows) and the weight operand
  in f32; then the bias plus the splits in order. ``passes`` 3 is the
  kernel's 3xTF32 (lo*hi + hi*lo + hi*hi), 1 plain TF32 (hi*hi)."""
  n, h, w, c = x.shape
  o = wgt.shape[-1]
  plan = gn_conv.launch_plan(n, h, w, c, o, groups)
  mean, rsqrt = (t.numpy() for t in gn_conv.gn_stats(torch.from_numpy(x),
                                                     groups))
  cg = c // groups
  scale = np.repeat(rsqrt, cg, axis=1) * gamma
  shift = beta - np.repeat(mean, cg, axis=1) * scale
  u = x * scale[:, None, None] + shift[:, None, None]
  act = np.zeros((plan.m, plan.cp), np.float32)
  act[:, :c] = (u / (1 + np.exp(-u))).reshape(plan.m, c)

  def split(a):
    return tuple(t.numpy() for t in gn_conv.tf32_split(torch.from_numpy(a)))

  w_hi, w_lo = (t.numpy() for t in gn_conv.weight_operand(
      torch.from_numpy(wgt)))
  used = plan.rows * w
  out = np.zeros((plan.grid[1] * used, plan.op), np.float32)
  bias = np.zeros(plan.op, np.float32)
  bias[:o] = b
  for tile in range(plan.grid[1]):
    total = bias.copy()
    for s in range(plan.splits):
      acc = np.zeros((gn_conv.BM, plan.op), np.float32)
      for chunk in split_chunks(plan, s):
        c0 = chunk * gn_conv.BK
        for tap in range(9):
          rows = tile_rows(plan, tile, n, h, w, tap)
          a = np.where(rows[:, None] >= 0,
                       act[np.maximum(rows, 0), c0:c0 + gn_conv.BK], 0)
          a_hi, a_lo = split(a.astype(np.float32))
          k = slice(tap * plan.cp + c0, tap * plan.cp + c0 + gn_conv.BK)
          acc += a_hi @ w_hi[k]
          if passes == 3:
            acc += a_lo @ w_hi[k] + a_hi @ w_lo[k]
      total = total + acc
    out[tile * used:(tile + 1) * used] = total[:used]
  return out[:plan.m, :o].reshape(n, h, w, o)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("n,h,w,c,o,groups", [(2, 8, 8, 32, 48, 8),
                                              (1, 4, 4, 64, 32, 16)])
def test_kernel_tf32x3_replay_matches_jax(n, h, w, c, o, groups, passes):
  """3xTF32 in the kernel's order and split-K partition meets the f32 bar
  against JAX; 1xTF32 does not, so the bar tells the two apart."""
  x, gamma, beta, wgt, b = _inputs(n, h, w, c, o)
  assert gn_conv.launch_plan(n, h, w, c, o, groups).splits > 1  # split-K
  want = np.asarray(jax_gn_conv.gn_silu_conv3x3_reference(
      jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
      jnp.asarray(wgt), jnp.asarray(b), groups))
  got = _replay_kernel(x, gamma, beta, wgt, b, groups, passes)
  if passes == 3:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  else:
    assert not np.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,w", [(3, 4, 4), (4, 5, 7)])
def test_tile_rows_map_pixels_and_zero_the_halo(n, h, w):
  """Each tile row's source pixel per tap, against an im2col of the
  zero-padded image, at a ragged 4x4 (48 of 128 rows, images sharing a
  tile) and an odd 5x7 (18 rows of 7 pixels a tile, 126 of 128 GEMM rows,
  the last tile ragged, images straddling tiles)."""
  plan = gn_conv.launch_plan(n, h, w, 16, 16, 4)
  used = plan.rows * w
  m = n * h * w
  flat = np.arange(m)
  padded = np.pad(flat.reshape(n, h, w) + 1, ((0, 0), (1, 1), (1, 1))) - 1
  for tap in range(9):
    dy, dx = divmod(tap, 3)
    want = padded[:, dy:dy + h, dx:dx + w].reshape(m)
    for tile in range(plan.grid[1]):
      got = tile_rows(plan, tile, n, h, w, tap)
      assert got.shape == (gn_conv.BM,)
      lo = tile * used
      live = min(used, m - lo)
      np.testing.assert_array_equal(got[:live], want[lo:lo + live])
      assert (got[live:] == -1).all()
    assert plan.grid[1] * used >= m


def test_launch_plan_fills_the_card_and_covers_k_once():
  """At the serving batch the split-K grid keeps the blocks the SMs hold
  at once busy wherever the tiles alone are fewer (as far as there are
  chunks to split), and the splits take every chunk once."""
  for shape in [(32, 32, 128, 128), (32, 32, 256, 256), (16, 16, 512, 256),
                (8, 8, 256, 256), (4, 4, 512, 256), (5, 7, 36, 20)]:
    plan = gn_conv.launch_plan(8, *shape, 4 if shape[2] % 32 else 32)
    tiles = plan.grid[0] * plan.grid[1]
    assert plan.grid[2] == plan.splits and plan.rows * shape[1] <= gn_conv.BM
    if tiles < gn_conv.H100_SMS // 2:
      assert tiles * plan.splits >= min(gn_conv.H100_SMS // 2,
                                        tiles * plan.chunks), shape
    chunks = [ch for s in range(plan.splits)
              for ch in split_chunks(plan, s)]
    assert chunks == list(range(plan.chunks)), shape
    assert plan.smem <= 232448


def test_cpu_wrapper_takes_plain_version_without_launching():
  x, gamma, beta, wgt, b = (torch.from_numpy(a)
                            for a in _inputs(2, 8, 8, 32, 48, seed=1))
  mean, rsqrt = gn_conv.gn_stats(x, 8)
  before = gn_conv.gn_silu_conv3x3.launches
  got = gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wgt, b, 8)
  want = gn_conv.gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, wgt, b, 8)
  assert torch.equal(got, want)
  assert gn_conv.gn_silu_conv3x3.launches == before


@pytest.mark.parametrize("fault", ["groups", "weight_shape", "needs_grad"])
def test_wrapper_refuses_what_it_does_not_take(fault):
  x, gamma, beta, wgt, b = (torch.from_numpy(a)
                            for a in _inputs(1, 4, 4, 16, 16, seed=2))
  mean, rsqrt = gn_conv.gn_stats(x, 4)
  groups = 4
  if fault == "groups":
    groups = 3
  elif fault == "weight_shape":
    wgt = wgt[:, :, :8]
  else:
    wgt.requires_grad_(True)
  with pytest.raises((ValueError, RuntimeError)):
    # forward-only: a gradient is refused from the Function's backward
    gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wgt, b,
                            groups).sum().backward()


def test_package_imports_without_nvcc_or_card():
  """Importing every module of the port builds nothing and needs no nvcc."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PATH=os.path.dirname(sys.executable),
             CUDA_HOME=os.path.join(repo, "no-cuda-here"),
             CUDA_VISIBLE_DEVICES="")
  code = ("import soft_truncation_tpu_torch.serve.server\n"
          "from soft_truncation_tpu_torch.ops import _build\n"
          "assert _build.load_library.cache_info().currsize == 0\n"
          "print('imported')\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr[-2000:]
  assert "imported" in proc.stdout


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
  """gn_silu_conv3x3 on the card against its plain version: split-K at 8x8
  and 4x4, ragged tiles at 5x7, C and O off the tile widths."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the gn_silu_conv3x3 kernel has no CPU "
                "mode")
  gn_conv.reset_launch_counts()
  cases = [(8, 8, 8, 256, 256, 32), (8, 4, 4, 512, 256, 32),
           (3, 5, 7, 36, 20, 12), (2, 32, 32, 128, 128, 32)]
  for n, h, w, c, o, groups in cases:
    x, gamma, beta, wgt, b = (torch.from_numpy(a).cuda()
                              for a in _inputs(n, h, w, c, o, seed=3))
    mean, rsqrt = gn_conv.gn_stats(x, groups)
    args = (x, mean, rsqrt, gamma, beta, wgt, b, groups)
    got = gn_conv.gn_silu_conv3x3(*args)
    want = gn_conv.gn_silu_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (n, h, w, c, o)
    # no atomics: the same bits again, from the caller's weight operand
    assert torch.equal(gn_conv.gn_silu_conv3x3(
        *args, w_split=gn_conv.weight_operand(wgt)), got)
  assert gn_conv.gn_silu_conv3x3.launches == 2 * len(cases)


def _tangent_args(n, h, w, c, o, groups, seed=5):
  """Primal and tangent inputs: x, dx and the stats with their tangents
  (forward mode through the plain gn_stats), gamma, beta, w."""
  x, gamma, beta, wgt, _ = (torch.from_numpy(a)
                            for a in _inputs(n, h, w, c, o, seed=seed))
  dx = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
      (n, h, w, c)).astype(np.float32))
  (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
      lambda v: gn_conv.gn_stats(v, groups), (x,), (dx,))
  return x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt


@pytest.mark.parametrize("n,h,w,c,o,groups", CASES)
def test_jvp_plain_matches_func_jvp_and_jax_jvp(n, h, w, c, o, groups):
  """The tangent written out (SiLU'(a) * da through the conv, no bias)
  against torch.func.jvp of the plain chain and jax.jvp of the JAX
  reference, whose stats move with x."""
  x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt = _tangent_args(
      n, h, w, c, o, groups)
  b = torch.ones(o)
  got = gn_conv.gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt, drsqrt,
                                          gamma, beta, wgt, groups)
  _, want = torch.func.jvp(
      lambda v: gn_conv.gn_silu_conv3x3_plain(
          v, *gn_conv.gn_stats(v, groups), gamma, beta, wgt, b, groups),
      (x,), (dx,))
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
  _, jax_want = jax.jvp(
      lambda v: jax_gn_conv.gn_silu_conv3x3_reference(
          v, jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()),
          jnp.asarray(wgt.numpy()), jnp.asarray(b.numpy()), groups),
      (jnp.asarray(x.numpy()),), (jnp.asarray(dx.numpy()),))
  np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=1e-5,
                             atol=1e-5)


def _with_storage(fn):
  """``fn`` that first checks that every tensor it gets has storage, as a
  kernel launch reads ``data_ptr()`` (a tensor that torch.func.jvp wraps
  has none)."""

  def checked(*args, **kwargs):
    for t in args:
      if isinstance(t, torch.Tensor):
        t.data_ptr()  # raises for a tensor without storage
    return fn(*args, **kwargs)

  return checked


def test_wrapper_jvp_takes_the_tangent_rule(monkeypatch):
  """Under torch.func.jvp (inside no_grad too) and with forward_ad dual
  tensors the wrapper's Function gives jvp_plain's tangent and its own
  primal, handing the tangent's computation tensors with storage (as the
  kernel needs them); a tangent of the weights is refused; no launch is
  counted on the CPU."""
  import torch.autograd.forward_ad as fwd
  monkeypatch.setattr(gn_conv, "gn_silu_conv3x3_jvp",
                      _with_storage(gn_conv.gn_silu_conv3x3_jvp))
  monkeypatch.setattr(gn_conv, "_primal", _with_storage(gn_conv._primal))
  n, h, w, c, o, groups = 2, 5, 7, 16, 8, 4
  x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt = _tangent_args(
      n, h, w, c, o, groups)
  b = torch.randn(o)
  want = gn_conv.gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt,
                                           drsqrt, gamma, beta, wgt, groups)

  def f(v):
    return gn_conv.gn_silu_conv3x3(v, *gn_conv.gn_stats(v, groups), gamma,
                                   beta, wgt, b, groups)

  gn_conv.reset_launch_counts()
  primal, tangent = torch.func.jvp(f, (x,), (dx,))
  assert torch.equal(primal, f(x)) and torch.equal(tangent, want)
  with torch.no_grad():
    assert torch.equal(torch.func.jvp(f, (x,), (dx,))[1], want)
  with fwd.dual_level():
    assert torch.equal(fwd.unpack_dual(f(fwd.make_dual(x, dx))).tangent,
                       want)
  with pytest.raises(NotImplementedError, match="constant"):
    torch.func.jvp(lambda v: gn_conv.gn_silu_conv3x3(
        x, mean, rsqrt, gamma, beta, v, b, groups), (wgt,), (wgt,))
  assert gn_conv.gn_silu_conv3x3.jvp_launches == 0
  assert gn_conv.gn_silu_conv3x3.launches == 0


def test_weight_operands_are_cached_plain_under_jvp():
  """DDPMConv's cached HWIO weights, TF32 split and the tangent's TF32
  split, made in a forward under torch.func.jvp, are plain tensors with
  storage (the kernels read them), made once per weight value; the
  tangent's is jvp_weight_operand's, the primal's in bf16."""
  from torch._C import _functorch
  from soft_truncation_tpu_torch.models.layers import DDPMConv
  conv = DDPMConv(16, 8)
  conv.reset_parameters(torch.Generator().manual_seed(0))
  made = []

  def f(v):
    made.extend([conv.weight_hwio(), *conv.weight_operand(),
                 *conv.jvp_weight_operand()])
    return v * 2.0

  torch.func.jvp(f, (torch.ones(2),), (torch.ones(2),))
  for t in made + [conv.weight_hwio(), *conv.weight_operand(),
                   *conv.jvp_weight_operand()]:
    assert not _functorch.is_functorch_wrapped_tensor(t)
    t.data_ptr()
  assert conv.weight_operand()[0] is made[1]  # cached once
  assert conv.jvp_weight_operand()[1] is made[4]
  for got, want in zip(made[3:], gn_conv.jvp_weight_operand(made[0])):
    assert torch.equal(got, want) and got.shape == (64, 9 * 32)
  with torch.no_grad():
    conv.weight.add_(1.0)  # a new weight value: new operands
  assert conv.jvp_weight_operand()[0] is not made[3]
  conv.dtype = torch.bfloat16
  assert conv.jvp_weight_operand() is conv.weight_operand()


# the flagship's fused site shapes (H, W, C, O) at batch 8 and the ragged
# shapes ops/gn_conv_sites.py checks on the card, with ``fits``' answer on
# each before the f32 tangent's redesign: all take the kernels
FLAGSHIP_SITES = [(32, 32, 128, 128), (32, 32, 256, 128), (32, 32, 384, 128),
                  (32, 32, 256, 256), (16, 16, 256, 256), (16, 16, 512, 256),
                  (16, 16, 384, 256), (16, 16, 128, 256), (16, 16, 128, 128),
                  (8, 8, 256, 256), (8, 8, 512, 256), (4, 4, 256, 256),
                  (4, 4, 512, 256)]
RAGGED = [(3, 5, 7, 36, 20, 12), (2, 4, 4, 16, 16, 4), (1, 32, 32, 128, 128, 32),
          (2, 3, 100, 24, 40, 4), (1, 3, 3, 8, 300, 4), (5, 2, 2, 12, 8, 3),
          (3, 1, 1, 8, 300, 4)]


def _site_cases():
  return ([(8,) + s + (min(s[2] // 4, 32),) for s in FLAGSHIP_SITES]
          + RAGGED + [(1, 64, 64, 128, 128, 32), (1, 8, 128, 1024, 1024, 32)])


# the block shape (GEMM rows, output channels) the f32 tangent's plan takes
# at each flagship site at batch 8: the fastest of the shapes the card
# timed there (PERF.md)
JVP_SHAPES = {(32, 32): (128, 128), (16, 16): (64, 128), (8, 8): (128, 128),
              (4, 4): (64, 64)}


def test_tangent_launch_plan_fits_every_site():
  """The f32 tangent's plan (csrc/gn_silu_conv3x3_jvp.cu) at the flagship's
  13 site shapes, the ragged ones and W = 64 and 128: within a block's
  shared memory (its own formula, 227 KB), the block's rows within 64 or
  128 GEMM rows (128 with at most 128 channels) and its partial tile
  within the ring it takes over, its cluster ranks take every 32-channel
  chunk and every output row once, a cluster of 2, 4 or 8 only where the
  tiles alone leave most SMs idle; the flagship's sites take the block
  shapes the card timed fastest; and ``fits`` still takes each of these
  shapes."""
  for n, h, w, c, o, groups in _site_cases():
    shape = (n, h, w, c, o)
    assert gn_conv.fits(n, h, w, c, o, groups), shape
    plan = gn_conv.launch_plan(n, h, w, c, o, groups, tangent=True)
    hp = (plan.rows + 2) * (plan.cols + 2)
    assert plan.smem == gn_conv.jvp_smem_bytes(hp, plan.block_n,
                                               plan.stages, plan.raws)
    assert plan.smem <= gn_conv._MAX_SMEM == 232448, shape
    assert plan.block_m in gn_conv.JVP_BLOCK_M, shape
    assert plan.block_m == 64 or plan.block_n <= 128, shape
    assert plan.cols == min(w, 64) and plan.rows == plan.block_m // plan.cols
    assert plan.stages in (2, 3, 4) and plan.raws in (1, 2)
    assert plan.cp % gn_conv.JVP_BK == 0 and plan.op % plan.block_n == 0
    assert plan.cp >= c and plan.op >= o
    assert plan.block_m * (plan.block_n + 8) * 4 <= (
        plan.stages * 2 * plan.block_n * 128), shape
    chunks = [ch for s in range(plan.splits) for ch in split_chunks(plan, s)]
    assert chunks == list(range(plan.chunks)), shape
    assert plan.splits in (1, 2, 4, 8)
    assert (plan.block_m // plan.splits) * plan.splits == plan.block_m
    tiles = plan.grid[0] * plan.grid[1]
    if plan.splits > 1:
      assert tiles <= gn_conv.H100_CLUSTERS[plan.splits], shape
      assert tiles * plan.splits <= gn_conv.H100_SMS, shape
    assert plan.grid[1] == -(-(n * h) // plan.rows) * -(-w // plan.cols)
    if n == 8 and (h, w) in JVP_SHAPES and (h, w, c, o) in FLAGSHIP_SITES:
      want = JVP_SHAPES[(h, w)]
      if (h, w, o) == (16, 16, 128):
        want = (64, 64)
      assert (plan.block_m, plan.block_n) == want, shape
  # a shape forced on the plan: the same invariants
  plan = gn_conv._jvp_plan(8, 16, 16, 256, 256, gn_conv.H100_SMS,
                           block_m=128, block_n=64)
  assert (plan.block_m, plan.block_n, plan.rows) == (128, 64, 8)
  assert plan.grid == (4, 16, 2) and plan.smem <= gn_conv._MAX_SMEM


def _jvp_replay(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, groups,
                passes, block_m=0):
  """numpy replay of csrc/gn_silu_conv3x3_jvp.cu: per M tile (bf16_tile's
  addressing: the halo tile with its zero row, each tap's rows) and per
  cluster rank, the rank's 32-channel chunks in order and the 9 taps of
  each, the activated tangent SiLU'(a) * da split into TF32 hi and lo
  against jvp_weight_operand's hi and lo in f32 (``passes`` 3: lo*hi +
  hi*lo + hi*hi; 1: hi*hi), then the ranks' partials summed in rank
  order; ``block_m`` forces the block's GEMM rows."""
  n, h, w, c = x.shape
  o = wgt.shape[-1]
  plan = (gn_conv._jvp_plan(n, h, w, c, o, gn_conv.H100_SMS, block_m=block_m)
          if block_m else gn_conv.launch_plan(n, h, w, c, o, groups,
                                              tangent=True))
  scale, shift = gn_conv._fold(mean, rsqrt, gamma, beta, groups)
  cg = c // groups
  dscale = drsqrt.repeat_interleave(cg, 1) * gamma
  dshift = -(dmean.repeat_interleave(cg, 1) * scale
             + mean.repeat_interleave(cg, 1) * dscale)
  a = x * scale[:, None, None] + shift[:, None, None]
  da = (dx * scale[:, None, None] + x * dscale[:, None, None]
        + dshift[:, None, None])
  s = torch.sigmoid(a)
  act = np.zeros((n * h * w, plan.cp), np.float32)
  act[:, :c] = (s * (1 + a * (1 - s)) * da).reshape(n * h * w, c).numpy()
  w_hi, w_lo = (t.numpy() for t in gn_conv.jvp_weight_operand(wgt))
  assert w_hi.shape == (plan.op, 9 * plan.cp)
  ck = gn_conv.JVP_BK
  got = np.zeros((n * h * w, o), np.float32)
  for tile in range(plan.grid[1]):
    halo, _, out = bf16_tile(plan, tile, n, h, w, 0)
    tile_act = np.vstack([np.where(halo[:, None] >= 0,
                                   act[np.maximum(halo, 0)], 0),
                          np.zeros((1, plan.cp), np.float32)])
    partials = []
    for rank in range(plan.splits):
      acc = np.zeros((plan.block_m, plan.op), np.float32)
      for ch in split_chunks(plan, rank):
        for tap in range(9):
          _, a_pix, _ = bf16_tile(plan, tile, n, h, w, tap)
          a_hi, a_lo = (t.numpy() for t in gn_conv.tf32_split(
              torch.from_numpy(tile_act[a_pix, ch * ck:(ch + 1) * ck].copy())))
          k = slice(tap * plan.cp + ch * ck, tap * plan.cp + (ch + 1) * ck)
          if passes == 3:
            acc += a_lo @ w_hi[:, k].T
            acc += a_hi @ w_lo[:, k].T
          acc += a_hi @ w_hi[:, k].T
      partials.append(acc)
    total = np.zeros_like(partials[0])
    for part in partials:  # rank order
      total += part
    got[out[out >= 0]] = total[out >= 0, :o]
  return got.reshape(n, h, w, o), plan


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("n,h,w,c,o,groups,block_m", [
    (2, 8, 8, 64, 48, 8, 0), (2, 3, 5, 36, 20, 12, 0),
    (2, 8, 8, 64, 48, 8, 128)])
def test_jvp_kernel_tf32x3_replay_matches_jax(n, h, w, c, o, groups, block_m,
                                              passes):
  """The f32 tangent's kernel arithmetic in its tiles, taps, halo, cluster
  split and 3xTF32 products meets the f32 bar against jax.jvp of the JAX
  reference (whose stats move with x); 1xTF32 does not. One shape splits
  two 32-channel chunks over a cluster of 2 on 8x8 images (in 64-row
  blocks of one image, and in a 128-row block of both), the other pads
  C = 36 to two chunks with 12-row tiles of 5-pixel rows over 3-row
  images and O = 20 in a 64-wide block."""
  x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt = _tangent_args(
      n, h, w, c, o, groups)
  got, plan = _jvp_replay(x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta,
                          wgt, groups, passes, block_m)
  assert plan.splits == 2 and plan.chunks == 2
  assert plan.block_m == (block_m or 64)
  _, want = jax.jvp(
      lambda v: jax_gn_conv.gn_silu_conv3x3_reference(
          v, jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()),
          jnp.asarray(wgt.numpy()), jnp.zeros(o), groups),
      (jnp.asarray(x.numpy()),), (jnp.asarray(dx.numpy()),))
  if passes == 3:
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
  else:
    assert not np.allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_library_name_follows_the_headers():
  """A library's name hashes its source and every header beside it, so
  that an edit of csrc/hopper.cuh builds each library anew."""
  import shutil
  import tempfile
  from pathlib import Path
  from soft_truncation_tpu_torch.ops import _build
  with tempfile.TemporaryDirectory() as tmp:
    csrc = Path(tmp) / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    names = ("gn_silu_conv3x3_jvp", "gn_silu_conv3x3_bf16", "fir2_bf16",
             "fir2")
    before = {n: _build.library_path(n, csrc) for n in names}
    assert before == {n: _build.library_path(n) for n in names}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: _build.library_path(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "gn_silu_conv3x3_jvp.cu").write_text("// another source\n")
    assert _build.library_path("gn_silu_conv3x3_jvp", csrc) != after[
        "gn_silu_conv3x3_jvp"]
    assert _build.library_path("fir2", csrc) == after["fir2"]


@pytest.mark.gpu
def test_tangent_kernel_matches_plain_on_card():
  """The tangent kernel on the card against gn_silu_conv3x3_jvp_plain
  (1e-4 of max |plain|, as the primal), counted as tangent launches, and
  the wrapper under torch.func.jvp launching both kernels."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the gn_silu_conv3x3 kernel has no CPU "
                "mode")
  gn_conv.reset_launch_counts()
  cases = [(8, 8, 8, 256, 256, 32), (8, 4, 4, 512, 256, 32),
           (3, 5, 7, 36, 20, 12), (2, 32, 32, 128, 128, 32)]
  for n, h, w, c, o, groups in cases:
    args = [t.cuda() for t in _tangent_args(n, h, w, c, o, groups)]
    got = gn_conv.gn_silu_conv3x3_jvp(*args, groups)
    want = gn_conv.gn_silu_conv3x3_jvp_plain(*args, groups)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max(), (n, h, w)
  x, dx, *_, gamma, beta, wgt = args
  b = torch.ones(wgt.shape[-1], device="cuda")
  _, tangent = torch.func.jvp(
      lambda v: gn_conv.gn_silu_conv3x3(v, *gn_conv.gn_stats(v, groups),
                                        gamma, beta, wgt, b, groups),
      (x,), (dx,))
  _, want = torch.func.jvp(
      lambda v: gn_conv.gn_silu_conv3x3_plain(
          v, *gn_conv.gn_stats(v, groups), gamma, beta, wgt, b, groups),
      (x,), (dx,))
  torch.cuda.synchronize()
  assert (tangent - want).abs().max() <= 1e-4 * want.abs().max()
  assert gn_conv.gn_silu_conv3x3.jvp_launches == len(cases) + 1
  assert gn_conv.gn_silu_conv3x3.launches == 1


# the bf16 kernel (csrc/gn_silu_conv3x3_bf16.cu) ---------------------------

# every fused site shape (H, W, C, O) of the 33 configs' layouts, as the
# configs test walks them
PUBLISHED_SITES = [
    (4, 4, 256, 256), (4, 4, 512, 256), (8, 8, 256, 256), (8, 8, 512, 256),
    (8, 8, 512, 512), (8, 8, 1024, 512), (16, 16, 128, 128),
    (16, 16, 128, 256), (16, 16, 256, 256), (16, 16, 384, 256),
    (16, 16, 512, 256), (16, 16, 512, 512), (16, 16, 1024, 512),
    (32, 32, 128, 128), (32, 32, 128, 256), (32, 32, 256, 128),
    (32, 32, 256, 256), (32, 32, 256, 512), (32, 32, 384, 128),
    (32, 32, 384, 256), (32, 32, 512, 256), (32, 32, 512, 512),
    (64, 64, 128, 128)]


def bf16_tile(plan, tile, n, h, w, tap):
  """The bf16 kernel's halo tile and A rows for ``tap`` in M tile ``tile``
  (blockIdx.y), as csrc/gn_silu_conv3x3_bf16.cu computes them: ``halo``,
  each of the tile's (rows + 2) x (cols + 2) halo pixels as a flat N*H*W
  index, -1 where it lies outside x (the kernel writes it 0); ``a_pix``,
  for GEMM row m its lane's ldmatrix pixel in that tile (its neighbour at
  dy, dx = divmod(tap, 3)), or hp, the zero row, where the tap leaves the
  image or the row lies past the tile or past N*H*W; ``out``, row m's
  output pixel, -1 for none."""
  segs = -(-w // plan.cols)
  row0, x0 = tile // segs * plan.rows, tile % segs * plan.cols
  w2 = plan.cols + 2
  hp = (plan.rows + 2) * w2
  pr, pc = np.divmod(np.arange(hp), w2)
  row, xc = row0 - 1 + pr, x0 - 1 + pc
  halo = np.where((row >= 0) & (row < n * h) & (xc >= 0) & (xc < w),
                  row * w + xc, -1)
  r, j = np.divmod(np.arange(plan.block_m or gn_conv.BF16_BM), plan.cols)
  rows = row0 + r
  live = (r < plan.rows) & (rows < n * h) & (x0 + j < w)
  dy, dx = divmod(tap, 3)
  y = rows % h + dy - 1
  a_pix = np.where(live & (y >= 0) & (y < h), (r + dy) * w2 + j + dx, hp)
  return halo, a_pix, np.where(live, rows * w + x0 + j, -1)


@pytest.mark.parametrize("n,h,w", [(3, 5, 7), (2, 3, 100), (4, 4, 4)])
def test_bf16_tile_rows_map_pixels_and_zero_the_halo(n, h, w):
  """Each GEMM row's source pixel per tap, through the halo tile and its
  zero row, against an im2col of the zero-padded image: tiles of 9 rows of
  7 pixels that straddle 5-row images (63 of 64 GEMM rows), a row of 100
  pixels cut into segments of 64 and 36, and 4x4 images 4 to a tile."""
  plan = gn_conv.launch_plan(n, h, w, 16, 16, 4, bf16=True)
  m = n * h * w
  padded = np.pad(np.arange(m).reshape(n, h, w) + 1,
                  ((0, 0), (1, 1), (1, 1))) - 1
  for tap in range(9):
    dy, dx = divmod(tap, 3)
    want = padded[:, dy:dy + h, dx:dx + w].reshape(m)
    seen = np.zeros(m, int)
    for tile in range(plan.grid[1]):
      halo, a_pix, out = bf16_tile(plan, tile, n, h, w, tap)
      got = np.append(halo, -1)[a_pix]  # the zero row reads as -1
      np.testing.assert_array_equal(got[out >= 0], want[out[out >= 0]])
      assert (a_pix[out < 0] == len(halo)).all()
      seen[out[out >= 0]] += 1
    assert (seen == 1).all()  # every output pixel in exactly one tile


def _bf16(a):
  return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("tangent", [False, True])
def test_bf16_kernel_replay_matches_plain(tangent):
  """numpy replay of the bf16 kernel at a ragged shape (5-pixel rows, 12
  rows a tile over 3-row images, C = 132: 8-byte copies and a padded last
  chunk, O = 20 in a 64-wide block, 3 chunks over a cluster of 2): the
  activated halo tile with its zero row, each tap's rows by bf16_tile, the
  f32 products of each rank's chunks, the partials summed in rank order
  plus the bias, one rounding; against the plain version at the bf16 bar
  (1e-2 of max |plain|: f32 sums in another order, then bf16)."""
  n, h, w, c, o, groups = 2, 3, 5, 132, 20, 12
  x, gamma, beta, wgt, b = _inputs(n, h, w, c, o, seed=7)
  tx, tw, tb = _bf16(x), _bf16(wgt), _bf16(b)
  g, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
  plan = gn_conv.launch_plan(n, h, w, c, o, groups, tangent=tangent,
                             bf16=True)
  assert plan.splits == 2 and plan.chunks == 3 and c % 8
  if tangent:
    tdx = _bf16(x[::-1].copy())
    (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
        lambda v: gn_conv.gn_stats(v, groups), (tx,), (tdx,))
    want = gn_conv.gn_silu_conv3x3_jvp_plain(tx, tdx, mean, dmean, rsqrt,
                                             drsqrt, g, bt, tw, groups)
    # the activated operand: SiLU'(a) * da, rounded as the kernel rounds it
    scale, shift = gn_conv._fold(mean, rsqrt, g, bt, groups)
    cg = c // groups
    dscale = drsqrt.repeat_interleave(cg, 1) * g
    dshift = -(dmean.repeat_interleave(cg, 1) * scale
               + mean.repeat_interleave(cg, 1) * dscale)
    a = tx.float() * scale[:, None, None] + shift[:, None, None]
    da = (tdx.float() * scale[:, None, None]
          + tx.float() * dscale[:, None, None] + dshift[:, None, None])
    s = torch.sigmoid(a)
    act = (s * (1 + a * (1 - s)) * da).bfloat16().float()
    bias = np.zeros(plan.op, np.float32)
  else:
    mean, rsqrt = gn_conv.gn_stats(tx, groups)
    want = gn_conv.gn_silu_conv3x3_plain(tx, mean, rsqrt, g, bt, tw, tb,
                                         groups)
    scale, shift = gn_conv._fold(mean, rsqrt, g, bt, groups)
    u = tx.float() * scale[:, None, None] + shift[:, None, None]
    act = torch.nn.functional.silu(u).bfloat16().float()
    bias = np.zeros(plan.op, np.float32)
    bias[:o] = tb.float().numpy()
  act_all = np.zeros((n * h * w, plan.cp), np.float32)
  act_all[:, :c] = act.reshape(n * h * w, c).numpy()
  (wt,) = gn_conv.weight_operand(tw)
  wt = wt.float().numpy()
  assert wt.shape == (plan.op, 9 * plan.cp)
  got = np.zeros((n * h * w, o), np.float32)
  ck = gn_conv.BF16_BK
  for tile in range(plan.grid[1]):
    partials = []
    for s in range(plan.splits):
      acc = np.zeros((gn_conv.BF16_BM, plan.op), np.float32)
      for ch in split_chunks(plan, s):
        for tap in range(9):
          halo, a_pix, out = bf16_tile(plan, tile, n, h, w, tap)
          tile_act = np.vstack([np.where(halo[:, None] >= 0,
                                         act_all[np.maximum(halo, 0)], 0),
                                np.zeros((1, plan.cp), np.float32)])
          a = tile_act[a_pix, ch * ck:(ch + 1) * ck]
          k = tap * plan.cp + ch * ck
          acc += a @ wt[:, k:k + ck].T
      partials.append(acc)
    total = np.zeros_like(partials[0])
    for part in partials:  # rank order
      total += part
    total += bias
    _, _, out = bf16_tile(plan, tile, n, h, w, 0)
    got[out[out >= 0]] = total[out >= 0, :o]
  got = torch.from_numpy(got).bfloat16().float().numpy().reshape(n, h, w, o)
  want = want.float().numpy()
  assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_bf16_launch_plan_covers_k_once_and_fits_every_site():
  """At every fused site shape of the 33 configs (batch 1, 8 and 128, both
  modes): the route ``fits`` gives is the kernel's; the bf16 plan fits a
  block's shared memory; its cluster ranks take every 64-channel chunk and
  every output row exactly once; a cluster of 2, 4 or 8 only where the
  tiles alone leave most SMs idle, and never more clusters than the H100
  holds at once."""
  for h, w, c, o in PUBLISHED_SITES:
    for n in (1, 8, 128):
      groups = min(c // 4, 32)
      assert gn_conv.fits(n, h, w, c, o, groups), (n, h, w, c, o)
      for tangent in (False, True):
        plan = gn_conv.launch_plan(n, h, w, c, o, groups, tangent=tangent,
                                   bf16=True)
        assert plan.smem <= gn_conv._MAX_SMEM, (n, h, w, c, o, tangent)
        assert plan.stages in (3, 4) and plan.raws in (1, 2)
        assert plan.cp % gn_conv.BF16_BK == 0 and plan.op % plan.block_n == 0
        chunks = [ch for s in range(plan.splits)
                  for ch in split_chunks(plan, s)]
        assert chunks == list(range(plan.chunks)), (n, h, w, c, o)
        per = gn_conv.BF16_BM // plan.splits
        assert per * plan.splits == gn_conv.BF16_BM
        tiles = plan.grid[0] * plan.grid[1]
        assert plan.splits in (1, 2, 4, 8)
        if plan.splits > 1:
          assert tiles <= gn_conv.H100_CLUSTERS[plan.splits]
          assert tiles * plan.splits <= gn_conv.H100_SMS


@pytest.mark.gpu
def test_bf16_kernels_match_plain_on_card():
  """Both bf16 entries on the card against their plain versions (the bf16
  bar, 1e-2 of max |plain|): a cluster of 4 at 8x8, tiles that straddle
  images with C % 8 != 0 and O off the block width, a 100-pixel row in two
  segments, 32x32 without a split; the same bits twice (no atomics); each
  launch counted as a bf16 launch."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the bf16 gn_silu_conv3x3 kernel has no "
                "CPU mode")
  gn_conv.reset_launch_counts()
  cases = [(8, 8, 8, 256, 256, 32), (3, 5, 7, 36, 20, 12),
           (2, 3, 100, 24, 40, 4), (2, 32, 32, 128, 128, 32)]
  for n, h, w, c, o, groups in cases:
    x, gamma, beta, wgt, b = (torch.from_numpy(a).cuda()
                              for a in _inputs(n, h, w, c, o, seed=3))
    x, dx, wgt, b = (t.bfloat16() for t in (x, x.flip(0), wgt, b))
    (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
        lambda v: gn_conv.gn_stats(v, groups), (x,), (dx,))
    primal = (x, mean, rsqrt, gamma, beta, wgt, b, groups)
    tangent = (x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, groups)
    for fn, plain, args in ((gn_conv.gn_silu_conv3x3,
                             gn_conv.gn_silu_conv3x3_plain, primal),
                            (gn_conv.gn_silu_conv3x3_jvp,
                             gn_conv.gn_silu_conv3x3_jvp_plain, tangent)):
      with torch.inference_mode():
        got, again = fn(*args), fn(*args)
        want = plain(*args)
      torch.cuda.synchronize()
      assert got.dtype == torch.bfloat16 and torch.equal(got, again)
      err = (got.float() - want.float()).abs().max().item()
      assert err <= 1e-2 * want.float().abs().max().item(), (n, h, w, c, o)
  assert gn_conv.gn_silu_conv3x3.bf16_launches == 2 * len(cases)
  assert gn_conv.gn_silu_conv3x3.bf16_jvp_launches == 2 * len(cases)
