"""The port's FIR resampling (soft_truncation_tpu_torch/ops/fir.py and
ops/resample.py) against the JAX package's, on the CPU.

The CUDA kernel (csrc/fir2.cu) runs only on the card: chip_smoke.py holds it
against its plain version there, and ``test_kernel_matches_plain_on_card``
does when a card is present. Here the plain versions are held against the
Pallas kernel in interpret mode and the lax path, and a numpy replay of the
kernel's index arithmetic (``tap_index`` in fir2.cu) against JAX, at
rtol = atol = 1e-5 as tests/test_pallas_fir.py: the same f32 products,
summed in another order.
"""

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


def _kernel_replay(x, k, gain, mode):
  """numpy replay of fir2.cu: per output, the flipped taps at
  ``tap_index``, summed over ty inside tx."""
  taps = fir.fir2_taps(k, gain, mode)[::-1].astype(np.float32)
  T = len(taps)
  pad0, _ = fir.fir2_pads(T, mode)
  n, h, w, c = x.shape
  oh, ow = fir._out_size(h, T, mode), fir._out_size(w, T, mode)

  def tap_index(o, t, L):
    if mode == "up":
      m = o + t - pad0
      if m & 1:
        return -1
      i = m >> 1
    else:
      i = 2 * o + t - pad0
    return i if 0 <= i < L else -1

  out = np.zeros((n, oh, ow, c), np.float32)
  for oy in range(oh):
    for ox in range(ow):
      acc = np.zeros((n, c), np.float32)
      for tx in range(T):
        ix = tap_index(ox, tx, w)
        if ix < 0:
          continue
        col = np.zeros((n, c), np.float32)
        for ty in range(T):
          iy = tap_index(oy, ty, h)
          if iy >= 0:
            col += taps[ty] * x[:, iy, ix]
        acc += taps[tx] * col
      out[:, oy, ox] = acc
  return out


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
def test_kernel_index_math_matches_jax(k, mode):
  x = _x((2, 6, 8, 3), seed=1)
  want = _jax_resample(x, KERNELS[k], 2.0, mode, "lax")
  np.testing.assert_allclose(_kernel_replay(x, KERNELS[k], 2.0, mode), want,
                             **TOL)


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
  """fir2 on the card against its plain version at the UNCSN++ shapes."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  fir.reset_launch_counts()
  gen = torch.Generator("cuda").manual_seed(0)
  for (h, c) in ((32, 128), (16, 256), (8, 256), (4, 256), (16, 3)):
    x = torch.randn(8, h, h, c, generator=gen, device="cuda")
    for wrapper, plain in ((fir.fir_upsample2, fir.fir_upsample2_plain),
                           (fir.fir_downsample2, fir.fir_downsample2_plain)):
      got, want = wrapper(x, [1, 3, 3, 1]), plain(x, [1, 3, 3, 1])
      torch.cuda.synchronize()
      err = (got - want).abs().max().item()
      assert err <= 1e-5 * want.abs().max().item(), (h, c, wrapper)
  assert fir.fir_upsample2.launches == fir.fir_downsample2.launches == 5
