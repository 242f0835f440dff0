"""The port's FIR resampling (soft_truncation_tpu_torch/ops/fir.py and
ops/resample.py) against the JAX package's, on the CPU.

The CUDA kernels (csrc/fir2.cu in f32, csrc/fir2_bf16.cu in bf16) run only
on the card: chip_smoke.py holds them against their plain version there,
and the ``gpu`` tests (here, and the bf16 kernel's in
tests/test_torch_fir_gpu.py, which imports no JAX) do when a card is
present. Here the plain
versions are held against the Pallas kernel in interpret mode and the lax
path, and numpy replays of the kernels' index arithmetic against JAX, at
rtol = atol = 1e-5 as tests/test_pallas_fir.py: the same f32 products,
summed in another order. The replays: fir2.cu's quads of up2 over the
launch plan's phase table and its per-output taps of down2; and the bf16
kernel's TMA route over ``band_plan``, each band computed from its box
alone (zero where the box lies outside the image, as TMA fills it), H sums
then W sums, on bf16 input. ``band_plan``'s invariants are asserted at the
models' shapes and ragged ones, with no JAX program.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.ops import resample as jax_resample
from soft_truncation_tpu.ops.pallas import fir as jax_fir
from soft_truncation_tpu_torch.ops import fir, resample

import torch_tiny  # noqa: F401  (caps torch's threads)

KERNELS = {"fir1331": [1., 3., 3., 1.], "box": [1., 1.],
           "len6": [1., 2., 4., 2., 1., 1.]}
SHAPES = [(2, 8, 8, 3), (1, 16, 16, 8)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _jax_fir2_args(k, gain, mode, shape=(1, 8, 8, 2)):
  """The (taps, pad0, pad1) that JAX's _fir2_op hands its Pallas kernel."""
  seen = {}

  def record(x, k1d, pad0, pad1, mode_):
    seen.update(taps=np.asarray(k1d), pads=(pad0, pad1), mode=mode_)
    return x

  orig = jax_fir._resample_pallas
  jax_fir._resample_pallas = record
  try:
    jax_fir._fir2_op(jnp.zeros(shape), tuple(k), gain, mode)
  finally:
    jax_fir._resample_pallas = orig
  assert seen["mode"] == mode
  return seen["taps"], seen["pads"]


@pytest.mark.parametrize("T", [2, 4, 6])
@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_taps_and_pads_equal_jax(T, mode, gain):
  k = [float(i % 3 + 1) for i in range(T)]
  taps, pads = _jax_fir2_args(k, gain, mode)
  assert fir.fir2_pads(T, mode) == pads
  np.testing.assert_array_equal(fir.fir2_taps(k, gain, mode), taps)
  if mode == "up":
    assert fir._phase_taps_up2(T, pads[0]) == jax_fir._phase_taps_up2(
        T, pads[0])


def _jax_resample(x, k, gain, mode, route):
  if route == "pallas":
    fn = (jax_fir.fir_upsample2_pallas if mode == "up"
          else jax_fir.fir_downsample2_pallas)
    return np.asarray(fn(jnp.asarray(x), k, gain=gain, interpret=True))
  fn = jax_resample.upsample_2d if mode == "up" else jax_resample.downsample_2d
  return np.asarray(fn(jnp.asarray(x), k, factor=2, gain=gain))


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_plain_matches_pallas_interpret_and_lax(k, shape, mode, gain):
  x = _x(shape)
  plain = fir.fir_upsample2_plain if mode == "up" else fir.fir_downsample2_plain
  got = plain(torch.from_numpy(x), KERNELS[k], gain).numpy()
  for route in ("pallas", "lax"):
    want = _jax_resample(x, KERNELS[k], gain, mode, route)
    assert got.shape == want.shape, route
    np.testing.assert_allclose(got, want, err_msg=route, **TOL)


def _kernel_replay(x, k, gain, mode, out_hw=None):
  """numpy replay of fir2.cu over the launch plan: up2 per 2x2 output quad
  (i, j), the S x S input pixels the four phases share summed per column
  into both row phases, then each column into both column phases; down2 per
  output, the flipped taps at 2*o + t - pad0. Taps outside [0, L) read 0."""
  plan = fir._plan(fir._taps_key(k), gain, mode)
  table = np.array(plan.table[:], np.float32)
  n, h, w, c = x.shape
  oh, ow = out_hw or (fir._out_size(h, plan.T, mode),
                      fir._out_size(w, plan.T, mode))
  out = np.zeros((n, oh, ow, c), np.float32)
  if mode == "up":
    S, lo = plan.length, plan.base
    coef = table.reshape(2, S)
    for i in range((oh + 1) // 2):
      for j in range((ow + 1) // 2):
        acc = np.zeros((2, 2, n, c), np.float32)
        for sx in range(S):
          ix = j + lo + sx
          if not 0 <= ix < w:
            continue
          col = np.zeros((2, n, c), np.float32)
          for sy in range(S):
            iy = i + lo + sy
            if 0 <= iy < h:
              col += coef[:, sy, None, None] * x[:, iy, ix]
          acc += coef[None, :, sx, None, None] * col[:, None]
        for p in range(2):
          for q in range(2):
            if 2 * i + p < oh and 2 * j + q < ow:
              out[:, 2 * i + p, 2 * j + q] = acc[p, q]
    return out
  kf, pad0 = table[:plan.T], plan.base
  for oy in range(oh):
    for ox in range(ow):
      acc = np.zeros((n, c), np.float32)
      for tx in range(plan.T):
        ix = 2 * ox + tx - pad0
        if not 0 <= ix < w:
          continue
        col = np.zeros((n, c), np.float32)
        for ty in range(plan.T):
          iy = 2 * oy + ty - pad0
          if 0 <= iy < h:
            col += kf[ty] * x[:, iy, ix]
        acc += kf[tx] * col
      out[:, oy, ox] = acc
  return out


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
def test_kernel_index_math_matches_jax(k, mode):
  x = _x((2, 6, 8, 3), seed=1)
  want = _jax_resample(x, KERNELS[k], 2.0, mode, "lax")
  np.testing.assert_allclose(_kernel_replay(x, KERNELS[k], 2.0, mode), want,
                             **TOL)


@pytest.mark.parametrize("k", sorted(KERNELS))
def test_quad_upsample_replay_one_row_past_2x(k):
  """Up2 sized 2H+1 x 2W+1 (the adjoint of a downsample of an odd size):
  the quads' last row and column read zeros past the input. JAX's reference
  is the upsample of the input zero-extended, cropped (on the shape of the
  test above, so no new compile)."""
  x = _x((2, 5, 7, 3), seed=9)
  xp = np.zeros((2, 6, 8, 3), np.float32)
  xp[:, :5, :7] = x
  want = _jax_resample(xp, KERNELS[k], 2.0, "up", "lax")[:, :11, :15]
  got = _kernel_replay(x, KERNELS[k], 2.0, "up", out_hw=(11, 15))
  np.testing.assert_allclose(got, want, **TOL)
  plain = fir._fir2_plain(torch.from_numpy(x), KERNELS[k], 2.0, "up",
                          (11, 15))
  np.testing.assert_allclose(plain.numpy(), want, **TOL)


def _box(x, start, extent):
  """x[start : start + extent] on every axis, zero outside x: a box as TMA
  fills it."""
  out = np.zeros(extent, np.float32)
  src = tuple(slice(max(s, 0), min(s + e, L))
              for s, e, L in zip(start, extent, x.shape))
  dst = tuple(slice(a.start - s, a.stop - s) for a, s in zip(src, start))
  if all(a.stop > a.start for a in src):
    out[dst] = x[src]
  return out


def _band_replay(x, k, gain, mode, out_hw=None):
  """numpy replay of fir2_bf16.cu's TMA route over ``band_plan``: each band
  summed from its box alone, H then W (product, then sum, in f32), the
  units past the output dropped."""
  taps = fir._plan(fir._taps_key(k), gain, mode)
  table = np.array(taps.table[:], np.float32)
  n, h, w, c = x.shape
  oh, ow = out_hw or (fir._out_size(h, taps.T, mode),
                      fir._out_size(w, taps.T, mode))
  plan = fir.band_plan(mode, taps.T, x.shape, (oh, ow))
  _, rows, cols = plan.band
  out = np.zeros((n, oh, ow, c), np.float32)
  for (n0, u0, v0, c0), start in fir.band_starts(plan):
    box = _box(x, start, plan.box)
    if mode == "down":
      kf = table[:taps.T]
      hs = sum(kf[t] * box[:, t:t + 2 * rows:2] for t in range(taps.T))
      band = sum(kf[t] * hs[:, :, t:t + 2 * cols:2] for t in range(taps.T))
      parts = [(band, 1, 0, 0)]
    else:
      coef = table.reshape(2, taps.length)
      hs = [sum(coef[p, s] * box[:, s:s + rows] for s in range(taps.length))
            for p in (0, 1)]
      parts = [(sum(coef[q, s] * hs[p][:, :, s:s + cols]
                    for s in range(taps.length)), 2, p, q)
               for p in (0, 1) for q in (0, 1)]
    for part, step, p, q in parts:
      assert part.shape == (plan.box[0], rows, cols, plan.box[3])
      ys = np.arange(rows)[:, None] + u0
      xs = np.arange(cols)[None, :] + v0
      ys, xs = ys * step + p + 0 * xs, xs * step + q + 0 * ys
      keep = (ys < oh) & (xs < ow)
      for i in range(min(plan.box[0], n - n0)):
        sel = part[i][keep][:, :c - c0]
        out[n0 + i, ys[keep], xs[keep], c0:c0 + sel.shape[-1]] = sel
  return out


def _bf16_values(x):
  """x rounded to bf16, as f32 (what the bf16 kernel reads)."""
  return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
def test_band_replay_matches_jax_and_plain(k, mode):
  """The bf16 TMA route's bands (C = 8: one slab, channels past C zero)
  against JAX's lax path and the plain version on bf16 input, in f32
  before the rounding (SHAPES' second shape: no new compile)."""
  x = _bf16_values(_x(SHAPES[1], seed=10))
  got = _band_replay(x, KERNELS[k], 2.0, mode)
  np.testing.assert_allclose(got, _jax_resample(x, KERNELS[k], 2.0, mode,
                                                "lax"), **TOL)
  plain = fir._fir2_plain(torch.from_numpy(x), KERNELS[k], 2.0, mode)
  np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize("k", sorted(KERNELS))
def test_band_replay_one_row_past_2x(k):
  """The bands of up2 sized 2H+1 x 2W+1 (as the quad replay above): the
  last unit row's second output row is dropped and its box reads zeros
  past the input."""
  x = _bf16_values(_x((2, 5, 7, 3), seed=9))
  xp = np.zeros((2, 6, 8, 3), np.float32)
  xp[:, :5, :7] = x
  want = _jax_resample(xp, KERNELS[k], 2.0, "up", "lax")[:, :11, :15]
  got = _band_replay(x, KERNELS[k], 2.0, "up", out_hw=(11, 15))
  np.testing.assert_allclose(got, want, **TOL)
  plain = fir._fir2_plain(torch.from_numpy(x), KERNELS[k], 2.0, "up",
                          (11, 15))
  np.testing.assert_allclose(got, plain.numpy(), **TOL)


# (mode, taps, x's shape, out_hw): the bf16 UNCSN++ step's and eval
# forward's shapes (forward, adjoint), the mesh's halo'd shard rows at
# CelebA-HQ 256^2, FFHQ 1024^2's widest levels (column tiles), odd sizes,
# 2H + 1, T = 2, 6 and 8, slabs past C, C that takes no tensor map
PLAN_CASES = [
    ("down", 4, (128, 32, 32, 128), None),
    ("down", 4, (128, 16, 16, 256), None),
    ("down", 4, (128, 8, 8, 256), None), ("down", 4, (128, 32, 32, 256), None),
    ("up", 4, (128, 4, 4, 256), None), ("up", 4, (128, 8, 8, 256), None),
    ("up", 4, (128, 16, 16, 256), None), ("up", 4, (128, 16, 16, 128), None),
    ("up", 4, (8, 4, 4, 256), None), ("down", 4, (8, 32, 32, 128), None),
    ("down", 4, (2, 68, 128, 128), None), ("up", 4, (2, 34, 64, 256), None),
    ("down", 4, (1, 1024, 1024, 32), None), ("up", 4, (1, 512, 512, 64), None),
    ("up", 4, (3, 5, 7, 72), (11, 15)), ("down", 4, (5, 33, 31, 64), None),
    ("up", 2, (7, 3, 3, 8), None), ("down", 6, (3, 20, 150, 16), None),
    ("up", 6, (1, 6, 140, 64), (13, 281)), ("down", 8, (2, 64, 64, 64), None),
    ("up", 8, (2, 9, 300, 24), None), ("up", 4, (2, 5, 7, 3), None),
    ("down", 4, (2, 9, 7, 12), None)]


@pytest.mark.parametrize("mode,T,shape,out_hw", PLAN_CASES)
def test_band_plan_invariants(mode, T, shape, out_hw):
  """Every output unit lies in exactly one band, every tap of every unit a
  band's threads sum (its unit columns in pairs) inside its box, boxes and
  shared memory within TMA's and the card's limits, the grid persistent,
  16-byte global strides on the TMA route, and the route: direct where
  C % 8 != 0, TMA at the training step's shapes."""
  n, h, w, c = shape
  out_hw = out_hw or (fir._out_size(h, T, mode), fir._out_size(w, T, mode))
  plan = fir.band_plan(mode, T, shape, out_hw, 132)
  assert plan is fir.band_plan(mode, T, shape, out_hw, 132)
  ur, uc = plan.units
  assert (ur, uc) == ((out_hw[0] + 1) // 2, (out_hw[1] + 1) // 2) if (
      mode == "up") else out_hw
  images, rows, cols = plan.band
  assert cols % 2 == 0 and min(images, rows, cols) >= 1
  assert max(plan.box[:3]) <= fir.BAND_MAX_BOX and plan.box[3] == fir.SLAB
  assert plan.box[1:3] == (plan.scale * rows + plan.halo,
                           plan.scale * cols + plan.halo)
  box_bytes = math.prod(plan.box) * 2
  assert plan.stage_bytes >= box_bytes and plan.stage_bytes % 1024 == 0
  assert 2 <= plan.stages <= fir.BAND_MAX_STAGES
  assert plan.smem == fir.BAND_ALIGN + plan.stages * plan.stage_bytes
  assert plan.smem <= fir.BAND_MAX_SMEM
  assert 1 <= plan.grid <= min(math.prod(plan.tiles),
                               fir.BAND_BLOCKS_PER_SM * 132)
  if mode == "up":
    lo, span = fir._up2_span(T)
    reads = [lo + s for s in range(span)]
  else:
    pad0 = fir.fir2_pads(T, mode)[0]
    reads = [t - pad0 for t in range(T)]
  cover = np.zeros((n, ur, uc, -(-c // fir.SLAB)), np.int32)
  for (n0, u0, v0, c0), (b0, y0, x0, ch0) in fir.band_starts(plan):
    assert (b0, ch0) == (n0, c0) and c0 % fir.SLAB == 0
    cover[n0:n0 + images, u0:u0 + rows, v0:v0 + cols, c0 // fir.SLAB] += 1
    for u in (u0, u0 + rows - 1):  # the band's first and last units
      for i in (plan.scale * u + r for r in reads):
        assert y0 <= i < y0 + plan.box[1], (u, i, y0)
    for v in (v0, v0 + cols - 1):
      for i in (plan.scale * v + r for r in reads):
        assert x0 <= i < x0 + plan.box[2], (v, i, x0)
  assert (cover == 1).all()
  if c % 8:
    assert plan.path == "direct"
  if n == 128:
    assert plan.path == "tma"
  if plan.path == "tma":
    assert all(s % 16 == 0 for s in (2 * c, 2 * w * c, 2 * h * w * c))


@pytest.mark.parametrize("k,gain,exact", [
    ([1., 3., 3., 1.], 1.0, True), ([1., 3., 3., 1.], 4.0, True),
    ([1., 3., 3., 1.], 0.25, True), ([1., 1.], 1.0, True),
    ([1., 3., 3., 1.], 2.0, False), (KERNELS["len6"], 1.0, False)])
def test_exact_products_decides_the_fma(k, gain, exact):
  """The bf16 kernel's H pass takes an FMA only where every tap times every
  bf16 value is exact in f32 (so it rounds as the plain version's product
  and sum do): checked against float64 products over bf16 values from the
  smallest subnormal up to 2^126, both signs (past it a product may
  overflow, to inf either way)."""
  bits = np.arange(1, 0x7E80, 7, dtype=np.uint32) << 16
  v = np.concatenate([bits, bits | 0x80000000]).view(np.float32).astype(
      np.float64)
  for mode in ("up", "down"):
    taps = fir._plan(tuple(k), gain, mode).taps
    assert fir._exact_products(taps) == exact
    products = [np.float32(t) * v.astype(np.float32) for t in taps]
    same = all(np.array_equal(p.astype(np.float64), float(t) * v)
               for p, t in zip(products, taps.astype(np.float64)))
    assert same == exact, (mode, taps)


def test_band_replay_matches_plain_at_ragged_shapes():
  """The bands at the plan cases that cut bands across images, rows and
  column tiles, with odd sizes, 2H + 1, T = 2, 6 and a second slab partly
  past C, against the plain version on bf16 input (no JAX program)."""
  taps = {2: [1., 1.], 4: [1., 3., 3., 1.], 6: KERNELS["len6"],
          8: [1., 2., 3., 4., 4., 3., 2., 1.]}
  for mode, T, shape, out_hw in [
      ("up", 4, (3, 5, 7, 72), (11, 15)), ("down", 4, (5, 33, 31, 8), None),
      ("up", 2, (7, 3, 3, 8), None), ("down", 6, (3, 20, 150, 8), None),
      ("up", 6, (1, 6, 140, 8), (13, 281)), ("down", 8, (2, 24, 64, 8), None),
      ("down", 4, (2, 68, 40, 8), None)]:
    x = _bf16_values(_x(shape, seed=11))
    got = _band_replay(x, taps[T], 1.0, mode, out_hw)
    plain = fir._fir2_plain(torch.from_numpy(x), taps[T], 1.0, mode, out_hw)
    np.testing.assert_allclose(got, plain.numpy(), err_msg=str(shape), **TOL)


@pytest.mark.parametrize("mode", ["up", "down"])
def test_launch_plan_holds_taps_and_pads_and_refuses_the_same(mode):
  """The cached plan returns fir2_taps / fir2_pads' values and a kernel
  table built from them (down2: the taps flipped; up2: _phase_taps_up2's
  taps at their offsets), and refuses what fir2_taps refuses."""
  for k in KERNELS.values():
    for gain in (1.0, 2.0):
      key = fir._taps_key(np.asarray(k))
      assert key == fir._taps_key(k) == tuple(k)
      plan = fir._plan(key, gain, mode)
      assert fir._plan(key, gain, mode) is plan
      taps = fir.fir2_taps(k, gain, mode).astype(np.float32)
      np.testing.assert_array_equal(plan.taps, taps)
      assert (plan.T, (plan.pad0, plan.pad1)) == (len(k),
                                                 fir.fir2_pads(len(k), mode))
      table = np.array(plan.table[:], np.float32)
      if mode == "down":
        assert (plan.length, plan.base) == (len(k), plan.pad0)
        np.testing.assert_array_equal(table, taps[::-1])
        continue
      coef = table.reshape(2, plan.length)
      for p, phase in enumerate(fir._phase_taps_up2(len(k), plan.pad0)):
        want = np.zeros(plan.length, np.float32)
        for ki, o in phase:
          want[o - plan.base] = taps[ki]
        np.testing.assert_array_equal(coef[p], want)
  for bad in ([1.] * (fir.MAX_TAPS + 1), [], np.outer([1, 3], [3, 1]),
              [[1., 3.], [3., 1.]]):
    with pytest.raises(ValueError):
      fir.fir2_taps(bad, 1.0, mode)
    with pytest.raises(ValueError):
      fir._plan(fir._taps_key(bad), 1.0, mode)


def test_upfirdn2d_matches_jax():
  """Asymmetric 2-D kernels, up and down, positive and negative pads."""
  x = _x((2, 9, 7, 4), seed=2)
  kern = np.random.default_rng(3).random((3, 4)).astype(np.float32)
  for up, down, pad in ((1, 1, (1, 2)), (2, 1, (2, -1)), (1, 2, (-1, 2)),
                        (3, 2, (0, 0)), (2, 3, (-2, -1))):
    want = np.asarray(jax_resample.upfirdn2d(jnp.asarray(x), kern, up=up,
                                             down=down, pad=pad))
    got = resample.upfirdn2d(torch.from_numpy(x), kern, up=up, down=down,
                             pad=pad).numpy()
    assert got.shape == want.shape, (up, down, pad)
    np.testing.assert_allclose(got, want, err_msg=str((up, down, pad)),
                               **TOL)


@pytest.mark.parametrize("op", ["upsample_conv_2d", "conv_downsample_2d"])
def test_fused_conv_resample_matches_jax(op):
  x = _x((2, 8, 8, 5), seed=4)
  w = (np.random.default_rng(5).standard_normal((3, 3, 5, 6))
       / 6.0).astype(np.float32)
  want = np.asarray(getattr(jax_resample, op)(jnp.asarray(x), jnp.asarray(w),
                                              k=(1, 3, 3, 1)))
  got = getattr(resample, op)(torch.from_numpy(x), torch.from_numpy(w),
                              k=(1, 3, 3, 1)).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,factor", [([1., 3., 3., 1.], 4),
                                      (np.outer([1, 3, 3, 1], [1, 3, 3, 1]),
                                       2)])
@pytest.mark.parametrize("mode", ["up", "down"])
def test_other_factors_and_2d_kernels_take_upfirdn2d(k, factor, mode):
  x = _x((1, 8, 8, 4), seed=6)
  fn = resample.upsample_2d if mode == "up" else resample.downsample_2d
  wrapper = fir.fir_upsample2 if mode == "up" else fir.fir_downsample2
  calls = []
  orig = fir._fir2_plain
  fir._fir2_plain = lambda *a: calls.append(a) or orig(*a)
  try:
    got = fn(torch.from_numpy(x), k, factor=factor).numpy()
  finally:
    fir._fir2_plain = orig
  assert not calls and wrapper.launches == 0
  jfn = (jax_resample.upsample_2d if mode == "up"
         else jax_resample.downsample_2d)
  np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x), k,
                                                 factor=factor)), **TOL)


def test_cpu_wrapper_takes_plain_version_without_launching():
  x = torch.from_numpy(_x((2, 8, 8, 4), seed=7))
  fir.reset_launch_counts()
  for wrapper, plain in ((fir.fir_upsample2, fir.fir_upsample2_plain),
                         (fir.fir_downsample2, fir.fir_downsample2_plain)):
    assert torch.equal(wrapper(x, [1, 3, 3, 1]), plain(x, [1, 3, 3, 1]))
    assert torch.equal(resample.upsample_2d(x, [1, 3, 3, 1])
                       if wrapper is fir.fir_upsample2
                       else resample.downsample_2d(x, [1, 3, 3, 1]),
                       plain(x, [1, 3, 3, 1]))
    assert wrapper.launches == 0 and wrapper.launches_by_shape == {}


@pytest.mark.parametrize("fault", ["taps", "kernel_2d", "rank", "device"])
def test_wrapper_refuses_what_it_does_not_take(fault):
  x = torch.from_numpy(_x((1, 8, 8, 4), seed=8))
  k = [1., 3., 3., 1.]
  if fault == "taps":
    k = [1.] * (fir.MAX_TAPS + 1)
  elif fault == "kernel_2d":
    k = np.outer(k, k)
  elif fault == "rank":
    x = x[0]
  else:
    x = x.to("meta")
  with pytest.raises((ValueError, RuntimeError)):
    fir.fir_upsample2(x, k)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
  """fir2 on the card against its plain version at the UNCSN++ shapes, for
  every kernel of KERNELS (up2's phase tables of S = 1, 3 and 3 taps wide)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  fir.reset_launch_counts()
  gen = torch.Generator("cuda").manual_seed(0)
  for (h, c) in ((32, 128), (16, 256), (8, 256), (4, 256), (16, 3)):
    x = torch.randn(8, h, h, c, generator=gen, device="cuda")
    for k in KERNELS.values():
      for wrapper, plain in ((fir.fir_upsample2, fir.fir_upsample2_plain),
                             (fir.fir_downsample2,
                              fir.fir_downsample2_plain)):
        got, want = wrapper(x, k), plain(x, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (h, c, k, wrapper)
  assert fir.fir_upsample2.launches == fir.fir_downsample2.launches == 15

