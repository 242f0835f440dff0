"""The port's VP SDE, score wrapper, dopri5 integrator and samplers against
the JAX package's, on the CPU.

Random draws are made once (numpy, or the JAX prior draw) and handed to
both sides. Tolerances: 1e-6 for the SDE and score algebra (the same f32
formulas); 1e-5 for dopri5 on a linear ODE, with equal nfe. The samplers
run the tiny random network, whose scores are large near t=eps (samples
reach a few hundred), so their bar is atol plus an rtol of 1e-6, a few f32
ulps at that magnitude: dpm_solver (4 steps) at atol 1e-4, the ode sampler
at atol 1e-3 with equal nfe.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inv
from soft_truncation_tpu.models.score import get_score_fn as jax_score_fn
from soft_truncation_tpu.sample import get_sampling_fn as jax_sampling_fn
from soft_truncation_tpu.sample.ode import odeint_dopri5 as jax_dopri5
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.sample import get_sampling_fn, odeint_dopri5
from soft_truncation_tpu_torch.sde import get_sde

import torch_tiny

RTOL = ATOL = 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol)


def _sdes():
  jc, pc = torch_tiny.configs()
  return jax_get_sde(jc), get_sde(pc)


def test_vpsde_matches_jax():
  jsde, psde = _sdes()
  rng = np.random.default_rng(0)
  x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
  t = np.array([1e-5, 0.37, 1.0], np.float32)
  nt = np.array([0.0, 0.3, 0.99], np.float32)
  px, pt, pnt = map(torch.from_numpy, (x, t, nt))
  for jout, pout in ((jsde.sde(x, t), psde.sde(px, pt)),
                     (jsde.marginal_prob(x, t), psde.marginal_prob(px, pt)),
                     (jsde.discretize(x, t), psde.discretize(px, pt)),
                     (jsde.discretize(x, t, nt), psde.discretize(px, pt, pnt))):
    for j, p in zip(jout, pout):
      _close(p, j)
  _close(psde.marginal_std(pt), jsde.marginal_std(t))
  _close(psde.prior_logp(px), jsde.prior_logp(x), rtol=1e-6, atol=1e-4)
  # a cumulative product of 1000 f32 factors, taken in another order
  _close(psde.sqrt_1m_alphas_cumprod(), jsde.sqrt_1m_alphas_cumprod(),
         rtol=1e-4)
  _close(psde.antiderivative(pt, 1e-3), jsde.antiderivative(t, 1e-3))


class _JaxLinear(flax_nn.Module):
  """A parameter-free stand-in network: out = x * (1 + labels / 1000)."""

  @flax_nn.compact
  def __call__(self, x, labels, train=False):
    return x * (1.0 + labels / 1000.0)[:, None, None, None]


class _PortLinear(torch.nn.Module):

  def forward(self, x, labels, train=False):
    return x * (1.0 + labels / 1000.0)[:, None, None, None]


@pytest.mark.parametrize("variant", ["continuous", "unbounded", "discrete"])
def test_score_fn_matches_jax(variant):
  jc, pc = torch_tiny.configs()
  for c in (jc, pc):
    c.training.unbounded_parametrization = variant == "unbounded"
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  continuous = variant != "discrete"
  rng = np.random.default_rng(1)
  x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
  t = np.array([1e-3, 0.37, 1.0], np.float32)
  want = jax_score_fn(jc, jsde, _JaxLinear(), {}, continuous=continuous)(x, t)
  got = get_score_fn(pc, psde, _PortLinear(), continuous=continuous)(
      torch.from_numpy(x), torch.from_numpy(t))
  _close(got, want)


def test_dopri5_linear_ode_matches_jax():
  """dy/dt = -0.5 beta(t) y from t=1 to 1e-3: same y and same nfe."""
  y0 = np.random.default_rng(2).standard_normal(96).astype(np.float32)

  def jfunc(t, y):
    return -0.5 * (0.1 + t * 19.9) * y

  def pfunc(t, y):
    return -0.5 * float(np.float32(0.1) + t * np.float32(19.9)) * y

  want = jax.jit(lambda y: jax_dopri5(jfunc, y, 1.0, 1e-3))(y0)
  got = odeint_dopri5(pfunc, torch.from_numpy(y0), 1.0, 1e-3)
  assert got.nfe == int(want.nfe) and got.status == int(want.status) == 0
  _close(got.y, want.y, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
  return torch_tiny.build()


@pytest.mark.parametrize("method,atol", [("dpm_solver", 1e-4), ("ode", 1e-3)])
def test_sampler_matches_jax_from_the_same_prior(tiny, method, atol):
  jc, pc, jmodel, params, pmodel = tiny
  for c in (jc, pc):
    c.sampling.method = method
    c.sampling.dpm_steps = 4
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  shape = torch_tiny.SHAPE
  key = jax.random.PRNGKey(3)
  x0 = np.asarray(jsde.prior_sampling(jax.random.split(key)[1], shape))
  jfn = jax_sampling_fn(jc, jsde, shape, jax_inv(jc),
                        jc.sampling.truncation_time)
  want, want_nfe = jax.jit(lambda p, k: jfn(jmodel, p, k))(params, key)
  pfn = get_sampling_fn(pc, psde, shape, get_data_inverse_scaler(pc),
                        pc.sampling.truncation_time)
  got, nfe = pfn(pmodel, x=torch.from_numpy(x0.copy()))
  assert nfe == int(want_nfe)
  assert got.shape == shape and torch.isfinite(got).all()
  _close(got, want, rtol=1e-6, atol=atol)
