"""The port's likelihood (soft_truncation_tpu_torch/likelihood/) against the
JAX package's, on the CPU, on both tiny models (``torch_tiny.SMALL``, weights
drawn by the port, init_scale 0.1 so that every conv carries signal), with
JAX's draws handed to the port.

Tolerances:
- the ODE function (the probability-flow drift and its Hutchinson
  divergence, one jvp) at t in {1e-5, 0.5, 1}: each part within 1e-5 of
  its own largest value. The divergence sums C*H*W products of both signs,
  so it is held to its own magnitude, not the drift's;
- the residual (both decoders) and the per-example NELBO (VP and
  reciprocal VE): 1e-4 relative to the largest value. Each is a sum over
  the image of f32 terms taken in another order.
The whole likelihood_fn against JAX's is in tests/test_torch_eval.py. The
port's bpd of unit-Gaussian data under the analytic VP score is held to
its closed form, as tests/test_sampling_likelihood.py holds JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inverse
from soft_truncation_tpu.likelihood import get_elbo_fn as jax_get_elbo_fn
from soft_truncation_tpu.likelihood import (
    get_likelihood_residual_fn as jax_get_residual_fn)
from soft_truncation_tpu.models.score import get_score_fn as jax_get_score_fn
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.sde.core import ReverseSDE as JaxReverseSDE
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.likelihood import (get_div_fn, get_elbo_fn,
                                                  get_likelihood_fn,
                                                  get_likelihood_residual_fn,
                                                  get_ode_fn)
from soft_truncation_tpu_torch.losses import make_draw
from soft_truncation_tpu_torch.sde import VPSDE, batch_mul, get_sde

import torch_tiny

FAMILIES = [torch_tiny.FLAGSHIP, torch_tiny.UNCSNPP]
SHAPE = (2, 8, 8, 3)
TIMES = (1e-5, 0.5, 1.0)


def _data(centered, seed=0):
  """Data on the 1/255 grid, scaled as the config scales it."""
  k = np.random.default_rng(seed).integers(0, 256, SHAPE)
  x = (k / 255.0).astype(np.float32)
  return 2.0 * x - 1.0 if centered else x


def _replay(draws):
  it = iter(draws)

  def draw(kind, shape):
    want_kind, value = next(it)
    assert (kind, tuple(shape)) == (want_kind, tuple(value.shape))
    return torch.from_numpy(np.array(value))

  draw.left = it
  return draw


def _rel_err(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", params=FAMILIES)
def tiny(request):
  return (request.param,) + torch_tiny.build(torch_tiny.SMALL, batch=2,
                                             family=request.param)


def test_ode_fn_matches_jax_jvp(tiny):
  """drift and eps^T (d drift / dx) eps from one torch.func.jvp, against
  jax.jvp of the JAX package's probability-flow drift."""
  family, jc, pc, jmodel, params, pmodel = tiny
  jsde = jax_get_sde(jc)
  rng = np.random.default_rng(1)
  x = (rng.standard_normal(SHAPE) * (1.0 if family == torch_tiny.FLAGSHIP
                                     else 5.0)).astype(np.float32)
  eps = np.where(rng.random(SHAPE) < 0.5, -1.0, 1.0).astype(np.float32)

  @jax.jit
  def jax_ode(p, x, t):
    score_fn = jax_get_score_fn(jc, jsde, jmodel, p, train=False,
                                continuous=True)
    rsde = JaxReverseSDE(jsde, score_fn,
                         probability_flow=jc.eval.probability_flow,
                         lambda_=jc.eval.lambda_)
    drift, tangent = jax.jvp(
        lambda v: rsde.sde(v, jnp.full((SHAPE[0],), t))[0], (x,),
        (jnp.asarray(eps),))
    return drift, jnp.sum((tangent * eps).reshape(SHAPE[0], -1), axis=-1)

  ode_fn = get_ode_fn(pc, get_sde(pc), pmodel, torch.from_numpy(eps))
  flat = torch.cat([torch.from_numpy(x).reshape(-1), torch.zeros(SHAPE[0])])
  for t in TIMES:
    want_drift, want_logp = jax_ode(params, x, np.float32(t))
    with torch.no_grad():
      got = ode_fn(np.float32(t), flat).numpy()
    n = x.size
    assert _rel_err(got[:n], np.asarray(want_drift).reshape(-1)) <= 1e-5, t
    assert _rel_err(got[n:], want_logp) <= 1e-5, t


@pytest.mark.parametrize("decoder,variance", [("none", "scoreflow"),
                                              ("lossless", "ddpm")])
def test_residual_matches_jax(decoder, variance):
  """The truncation residual with the Gaussian and the discretized-Gaussian
  decoder, JAX's z handed to the port."""
  changes = dict(torch_tiny.SMALL, data=dict(torch_tiny.SMALL["data"],
                                             dequantization=decoder))
  jc, pc, jmodel, params, pmodel = torch_tiny.build(changes, batch=2)
  x = _data(pc.data.centered)
  key = jax.random.PRNGKey(4)
  want = jax.jit(lambda p, b: jax_get_residual_fn(
      jc, jax_get_sde(jc), jmodel, p, variance=variance)(b, key, 1e-3))(
          params, x)
  got = get_likelihood_residual_fn(pc, get_sde(pc), pmodel, variance)(
      torch.from_numpy(x), 1e-3, draw=_replay(
          [("normal", jax.random.normal(key, SHAPE))]))
  assert _rel_err(got, want) <= 1e-4


def test_elbo_matches_jax(tiny):
  """Per-example NELBO and residual bpd (VP: importance-sampled t with its
  normaliser; reciprocal VE: uniform 1/t, q_t and rve_scale)."""
  family, jc, pc, jmodel, params, pmodel = tiny
  x = _data(pc.data.centered, seed=2)
  key = jax.random.PRNGKey(5)
  jfn = jax_get_elbo_fn(jc, jax_get_sde(jc), inverse_scaler=jax_inverse(jc))
  want_nelbo, want_res = jax.jit(lambda p, b: jfn(jmodel, p, b, key))(params,
                                                                      x)
  k_t, k_z, k_h, k_lp, k_res = jax.random.split(key, 5)
  draw = _replay([("uniform", jax.random.uniform(k_t, (SHAPE[0],))),
                  ("normal", jax.random.normal(k_z, SHAPE)),
                  ("rademacher", jax.random.rademacher(k_h, SHAPE,
                                                       dtype=jnp.float32)),
                  ("normal", jax.random.normal(k_lp, SHAPE)),
                  ("normal", jax.random.normal(k_res, SHAPE))])
  nelbo, res = get_elbo_fn(pc, get_sde(pc), get_data_inverse_scaler(pc))(
      pmodel, torch.from_numpy(x), draw=draw)
  assert next(draw.left, None) is None
  assert _rel_err(nelbo, want_nelbo) <= 1e-4, family
  assert _rel_err(res, want_res) <= 1e-4, family


def test_div_fn_is_exact_for_a_diagonal_map():
  """eps^T (d fn) eps for fn(x) = c * x with Rademacher eps is sum(c)."""
  c = torch.linspace(-2.0, 3.0, 48).reshape(1, 4, 4, 3)
  eps = make_draw(torch.Generator().manual_seed(0), "cpu")("rademacher",
                                                           (2, 4, 4, 3))
  assert set(eps.unique().tolist()) == {-1.0, 1.0}
  div = get_div_fn(lambda x, t: c * x)(torch.randn(2, 4, 4, 3), None, eps)
  np.testing.assert_allclose(div.numpy(), [c.sum().item()] * 2, rtol=1e-6)


class _AnalyticVPModel:
  """Network whose calibrated score (ddpm_score) is exactly -x: unit-Gaussian
  data under the VP SDE stay N(0, I), the drift is 0."""

  def __init__(self, sde):
    self.sde = sde

  def __call__(self, x, labels, train=False):
    return batch_mul(self.sde.marginal_std(labels / 999.0), x)


def test_bpd_of_analytic_gaussian():
  """'wrong' mode: z = data and the bpd is the standard-normal density's.
  'correct' mode (a perturbed start, minus the residual) from JAX's draws:
  JAX's bpd to 1e-4. (Not the same nfe: the drift is f32 rounding, ~1e-7,
  and dopri5's first step size is set by its ratio to the state, so each
  side's step sequence follows its own rounding.)"""
  from soft_truncation_tpu.likelihood import (
      get_likelihood_fn as jax_get_likelihood_fn)
  from test_sampling_likelihood import AnalyticVPModel, vp_config
  config = default_config("cifar10")
  override(config, {
      "training": dict(sde="vpsde", continuous=True, ddpm_score=True,
                       unbounded_parametrization=False),
      "data": dict(image_size=4, num_channels=1, centered=True),
  })
  sde = get_sde(config)
  assert isinstance(sde, VPSDE)
  model = _AnalyticVPModel(sde)
  inverse_scaler = get_data_inverse_scaler(config)
  likelihood_fn = get_likelihood_fn(config, sde, inverse_scaler)
  data = np.random.default_rng(0).standard_normal((4, 4, 4, 1)).astype(
      np.float32)
  bpd, z, nfe = likelihood_fn(model, torch.from_numpy(data),
                              torch.Generator().manual_seed(1), mode="wrong")
  np.testing.assert_allclose(z.numpy(), data, atol=1e-3)
  d = 16
  logp = -d / 2 * math.log(2 * math.pi) - (data.reshape(4, -1) ** 2).sum(
      -1) / 2
  want = -logp / d / math.log(2) + 7.0 - inverse_scaler(-1.0)
  np.testing.assert_allclose(bpd.numpy(), want, rtol=1e-3)
  assert nfe > 0

  jconfig = vp_config()
  jsde = jax_get_sde(jconfig)
  key = jax.random.PRNGKey(1)
  jax_fn = jax_get_likelihood_fn(jconfig, jsde, lambda v: (v + 1.0) / 2.0)
  want_c = jax.jit(lambda b: jax_fn(AnalyticVPModel(jsde), {}, b, key,
                                    mode="correct")[0])(data)
  k_hutch, k_pert, k_resid = jax.random.split(key, 3)
  shape = data.shape
  draw = _replay([("rademacher", jax.random.rademacher(k_hutch, shape,
                                                       dtype=jnp.float32)),
                  ("normal", jax.random.normal(k_pert, shape)),
                  ("normal", jax.random.normal(k_resid, shape))])
  bpd_c, _, _ = likelihood_fn(model, torch.from_numpy(data), mode="correct",
                              draw=draw)
  assert next(draw.left, None) is None
  np.testing.assert_allclose(bpd_c.numpy(), np.asarray(want_c), rtol=0,
                             atol=1e-4)
