"""The backward of the port's 2x FIR resample (the autograd Function of
soft_truncation_tpu_torch/ops/fir.py) against the JAX package's, on the CPU.

Even T: the port's backward is the forward in the other mode with reversed
taps and gain 4g (adjoint of up) or g/4 (adjoint of down), as JAX's
``_fir2_bwd``; it is held against that call of JAX's Pallas kernel in
interpret mode and against ``jax.vjp`` of the lax path (``ops/resample.py``,
the true adjoint). The adjoint of a downsample of an odd-sized input is the
same upsample sized to that input (one row and column past 2x the
cotangent), held against ``jax.vjp``. Odd T takes the transpose of the
general ``upfirdn2d``, held against ``jax.vjp``.
Tolerance rtol = atol = 1e-5 as tests/test_torch_fir.py: the same f32
products, summed in another order. ``gradcheck`` / ``gradgradcheck`` run in
float64 at 2x4x4x3 at their default tolerances. On the card the backward
launches the fir2 kernel: ``test_backward_on_card_matches_autograd_of_plain``
(marked ``gpu``) and chip_smoke.py hold it there.

Forward mode: the Function's jvp is the same resample of the tangent, held
under torch.func.jvp and forward_ad against the plain version and jax.jvp
of the JAX lax path; on the card it is one more fir2 launch, counted as a
tangent launch (``test_tangent_on_card_matches_plain``, marked ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.ops import resample as jax_resample
from soft_truncation_tpu.ops.pallas import fir as jax_fir
from soft_truncation_tpu_torch.ops import fir, resample

import torch_tiny  # noqa: F401  (caps torch's threads)

KERNELS = {"fir1331": [1., 3., 3., 1.], "asym4": [1., 2., 5., 3.],
           "odd3": [1., 2., 1.]}
TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _wrapper(mode):
  return fir.fir_upsample2 if mode == "up" else fir.fir_downsample2


def _jax_vjp(x, ybar, k, gain, mode):
  fn = jax_resample.upsample_2d if mode == "up" else jax_resample.downsample_2d
  _, vjp = jax.vjp(lambda v: fn(v, k, factor=2, gain=gain), jnp.asarray(x))
  return np.asarray(vjp(jnp.asarray(ybar))[0])


def _port_grad(x, ybar, k, gain, mode):
  xt = torch.from_numpy(x).requires_grad_(True)
  y = _wrapper(mode)(xt, k, gain)
  assert tuple(y.shape) == ybar.shape
  y.backward(torch.from_numpy(ybar))
  return xt.grad.numpy()


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_backward_matches_jax(k, mode, gain):
  taps = KERNELS[k]
  x = _x((2, 8, 8, 3))
  ybar = _x((2, 16, 16, 3) if mode == "up" else (2, 4, 4, 3), seed=1)
  got = _port_grad(x, ybar, taps, gain, mode)
  np.testing.assert_allclose(got, _jax_vjp(x, ybar, taps, gain, mode),
                             err_msg="jax.vjp of the lax path", **TOL)
  if len(taps) % 2 == 0:  # _fir2_bwd: the other mode, reversed taps
    other = (jax_fir.fir_downsample2_pallas if mode == "up"
             else jax_fir.fir_upsample2_pallas)
    want = other(jnp.asarray(ybar), taps[::-1],
                 gain=4.0 * gain if mode == "up" else gain / 4.0,
                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(want),
                               err_msg="JAX's Pallas backward", **TOL)


def test_backward_of_odd_sized_downsample_matches_jax():
  """A 7x7 input downsamples to 3x3, whose plain 2x upsample is 6x6: the
  adjoint is the mirrored upsample sized to 7x7, taken through the same
  route (counted as a backward launch on the card)."""
  x = _x((2, 7, 7, 3))
  ybar = _x((2, 3, 3, 3), seed=1)
  np.testing.assert_allclose(_port_grad(x, ybar, KERNELS["fir1331"], 1.0,
                                        "down"),
                             _jax_vjp(x, ybar, KERNELS["fir1331"], 1.0,
                                      "down"), **TOL)


@pytest.mark.parametrize("k", ["fir1331", "asym4"])
def test_gradcheck_of_odd_sized_downsample(k):
  """Double backward of the sized adjoint: its own adjoint is the
  downsample of the odd-sized cotangent, back to the cotangent's size."""
  x = torch.from_numpy(_x((2, 5, 7, 3)).astype(np.float64)).requires_grad_()

  def f(v):
    return fir.fir_downsample2(v, KERNELS[k], 2.0)

  assert tuple(f(x).shape) == (2, 2, 3, 3)
  assert torch.autograd.gradcheck(f, (x,))
  assert torch.autograd.gradgradcheck(f, (x,))


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
def test_gradcheck_and_double_backward(k, mode):
  x = torch.from_numpy(_x((2, 4, 4, 3)).astype(np.float64)).requires_grad_()

  def f(v):
    return _wrapper(mode)(v, KERNELS[k], 2.0)

  assert torch.autograd.gradcheck(f, (x,))
  assert torch.autograd.gradgradcheck(f, (x,))


def test_gradients_flow_through_resample_and_fused_convs():
  """upsample_2d / downsample_2d route to the Function; upfirdn2d,
  upsample_conv_2d and conv_downsample_2d take autograd through torch ops.
  Each gradient against jax.vjp of the JAX package's op."""
  x = _x((2, 8, 8, 4), seed=2)
  w = (_x((3, 3, 4, 5), seed=3) / 6.0).astype(np.float32)
  k = (1, 3, 3, 1)
  ops = {
      "upsample_2d": (lambda m, v, w_: m.upsample_2d(v, k, factor=2), False),
      "downsample_2d": (lambda m, v, w_: m.downsample_2d(v, k, factor=2),
                        False),
      "upfirdn2d": (lambda m, v, w_: m.upfirdn2d(
          v, np.outer([1., 2., 1.], [1., 3., 3., 1.]), up=2, down=1,
          pad=(2, 1)), False),
      "upsample_conv_2d": (lambda m, v, w_: m.upsample_conv_2d(v, w_, k=k),
                           True),
      "conv_downsample_2d": (lambda m, v, w_: m.conv_downsample_2d(v, w_,
                                                                   k=k),
                             True),
  }
  for name, (op, has_w) in ops.items():
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = op(resample, xt, wt)
    ybar = _x(tuple(y.shape), seed=4)
    y.backward(torch.from_numpy(ybar))
    out, vjp = jax.vjp(lambda v, w_: op(jax_resample, v, w_), jnp.asarray(x),
                       jnp.asarray(w))
    assert out.shape == ybar.shape, name
    want_x, want_w = vjp(jnp.asarray(ybar))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               err_msg=name, **TOL)
    if has_w:
      np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w),
                                 err_msg=name, **TOL)


def test_cpu_backward_counts_no_launch():
  fir.reset_launch_counts()
  x = torch.from_numpy(_x((2, 8, 8, 4))).requires_grad_(True)
  resample.downsample_2d(resample.upsample_2d(x, [1, 3, 3, 1]),
                         [1, 3, 3, 1]).sum().backward()
  for wrapper in (fir.fir_upsample2, fir.fir_downsample2):
    assert wrapper.launches == wrapper.backward_launches == 0
    assert wrapper.backward_launches_by_shape == {}


def test_function_only_where_autograd_records(monkeypatch):
  """Serving (inference_mode, or no_grad with no forward-mode level open)
  calls the resample directly; with grad mode on, whether or not the input
  needs a gradient, and under torch.func.jvp even inside no_grad, the call
  goes through the Function, whose jvp is the same resample."""
  applied = []
  orig = fir._Fir2.apply
  monkeypatch.setattr(fir._Fir2, "apply",
                      lambda *a: applied.append(a[3]) or orig(*a))
  x = torch.from_numpy(_x((2, 8, 8, 4)))
  want = fir.fir_upsample2_plain(x, [1, 3, 3, 1])
  with torch.inference_mode():
    got_inference = fir.fir_upsample2(x, [1, 3, 3, 1])
  with torch.no_grad():
    fir.fir_upsample2(x.requires_grad_(True), [1, 3, 3, 1])
  assert applied == []
  fir.fir_upsample2(x.detach(), [1, 3, 3, 1])
  assert applied == ["up"]
  fir.fir_upsample2(x, [1, 3, 3, 1]).sum().backward()
  assert applied == ["up"] * 2  # the backward's cotangent: grad mode off
  with torch.no_grad():
    _, tangent = torch.func.jvp(lambda v: fir.fir_downsample2(v, [1, 3, 3, 1]),
                                (x.detach(),), (x.detach(),))
  # (torch.func.jvp re-enters apply one level down)
  assert applied[:2] == ["up", "up"] and set(applied[2:]) == {"down"}
  assert torch.equal(got_inference, want)
  assert torch.equal(tangent, fir.fir_downsample2_plain(x.detach(),
                                                        [1, 3, 3, 1]))


@pytest.mark.parametrize("k", sorted(KERNELS))
@pytest.mark.parametrize("mode", ["up", "down"])
def test_jvp_matches_plain_and_jax(k, mode, monkeypatch):
  """torch.func.jvp through the wrapper: primal and tangent against the
  plain version (the resample is linear, so its tangent is the resample of
  the tangent, the same bits) and against jax.jvp of the lax path. The
  resample gets tensors with storage, as the kernel's launch reads them."""
  import torch.autograd.forward_ad as fwd
  resample_ = fir._resample

  def with_storage(x, *args):
    x.data_ptr()  # raises for a tensor that torch.func.jvp wrapped
    return resample_(x, *args)

  monkeypatch.setattr(fir, "_resample", with_storage)
  x, dx = _x((2, 6, 8, 3)), _x((2, 6, 8, 3), seed=1)
  plain = (fir.fir_upsample2_plain if mode == "up"
           else fir.fir_downsample2_plain)
  fir.reset_launch_counts()
  primal, tangent = torch.func.jvp(lambda v: _wrapper(mode)(v, KERNELS[k], 2.0),
                                   (torch.from_numpy(x),),
                                   (torch.from_numpy(dx),))
  assert torch.equal(primal, plain(torch.from_numpy(x), KERNELS[k], 2.0))
  assert torch.equal(tangent, plain(torch.from_numpy(dx), KERNELS[k], 2.0))
  fn = jax_resample.upsample_2d if mode == "up" else jax_resample.downsample_2d
  _, want = jax.jvp(lambda v: fn(v, KERNELS[k], factor=2, gain=2.0),
                    (jnp.asarray(x),), (jnp.asarray(dx),))
  np.testing.assert_allclose(tangent.numpy(), np.asarray(want), **TOL)
  with fwd.dual_level():
    dual = _wrapper(mode)(fwd.make_dual(torch.from_numpy(x),
                                        torch.from_numpy(dx)), KERNELS[k],
                          2.0)
    assert torch.equal(fwd.unpack_dual(dual).tangent, tangent)
  assert _wrapper(mode).jvp_launches == 0  # the CPU counts no launch


@pytest.mark.gpu
def test_backward_on_card_matches_autograd_of_plain():
  """The adjoint launched on the card against torch.autograd.grad of the
  plain forward, at the UNCSN++ shapes, with the backward tally."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  fir.reset_launch_counts()
  gen = torch.Generator("cuda").manual_seed(0)
  k = [1., 3., 3., 1.]
  for (h, c) in ((32, 128), (16, 256), (8, 256)):
    for mode in ("up", "down"):
      x = torch.randn(4, h, h, c, generator=gen, device="cuda",
                      requires_grad=True)
      plain = (fir.fir_upsample2_plain if mode == "up"
               else fir.fir_downsample2_plain)
      ybar = torch.randn(plain(x.detach(), k).shape, generator=gen,
                         device="cuda")
      (got,) = torch.autograd.grad(_wrapper(mode)(x, k), x, ybar)
      (want,) = torch.autograd.grad(plain(x, k), x, ybar)
      torch.cuda.synchronize()
      assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (h, mode)
  # an odd-sized downsample: its adjoint launches the upsample at 2M+1
  x = torch.randn(4, 33, 31, 8, generator=gen, device="cuda",
                  requires_grad=True)
  ybar = torch.randn(4, 16, 15, 8, generator=gen, device="cuda")
  (got,) = torch.autograd.grad(fir.fir_downsample2(x, k), x, ybar)
  (want,) = torch.autograd.grad(fir.fir_downsample2_plain(x, k), x, ybar)
  torch.cuda.synchronize()
  assert (got - want).abs().max() <= 1e-5 * want.abs().max()
  assert fir.fir_upsample2.backward_launches == 3
  assert fir.fir_downsample2.backward_launches == 4
  assert fir.fir_downsample2.backward_launches_by_shape[(16, 15, 8)] == 1


@pytest.mark.gpu
def test_tangent_on_card_matches_plain():
  """Under torch.func.jvp on the card each wrapper launches fir2 for the
  primal and again for the tangent, per shape, each against the plain
  version (1e-5)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  fir.reset_launch_counts()
  gen = torch.Generator("cuda").manual_seed(2)
  k = [1., 3., 3., 1.]
  for (h, c) in ((32, 128), (8, 256)):
    for mode in ("up", "down"):
      x = torch.randn(4, h, h, c, generator=gen, device="cuda")
      dx = torch.randn(4, h, h, c, generator=gen, device="cuda")
      plain = (fir.fir_upsample2_plain if mode == "up"
               else fir.fir_downsample2_plain)
      _, got = torch.func.jvp(lambda v: _wrapper(mode)(v, k), (x,), (dx,))
      want = plain(dx, k)
      torch.cuda.synchronize()
      assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (h, mode)
  for wrapper in (fir.fir_upsample2, fir.fir_downsample2):
    assert wrapper.launches == wrapper.jvp_launches == 2
    assert wrapper.jvp_launches_by_shape == {(32, 32, 128): 1,
                                             (8, 8, 256): 1}
