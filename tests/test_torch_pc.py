"""The port's Predictor-Corrector sampler (soft_truncation_tpu_torch/sample/
sampling.py) against the JAX package's, on the CPU.

JAX and torch draw different numbers from their generators, so every test
hands the port the noise that JAX's keys draw, in the order JAX draws it
(the port's ``draw`` argument). Tolerances: 1e-6 for one predictor or
corrector step on a linear stand-in network (the same f32 formulas; the
Langevin step size goes through two norms summed in another order, 1e-5);
the tiny UNCSN++ run at 1e-4 of the samples' largest value, the forward's
bar (rtol 1e-4 of the output scale) carried through 4 steps.
"""

import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inv
from soft_truncation_tpu.models.score import get_score_fn as jax_score_fn
from soft_truncation_tpu.sample import get_sampling_fn as jax_sampling_fn
from soft_truncation_tpu.sample import sampling as jax_sampling
from soft_truncation_tpu.sde import ReverseSDE as JaxReverseSDE
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.eval.sampling_io import _to_uint8
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.sample import get_sampling_fn, sampling
from soft_truncation_tpu_torch.sde import ReverseSDE, get_sde
from soft_truncation_tpu_torch.serve.server import (SamplingService,
                                                    _round_seed)

import torch_tiny
from test_torch_sampling import _JaxLinear, _PortLinear
from test_torch_uncsnpp import TINY

SHAPE = (2, 4, 4, 3)


def _replay(noises):
  """A ``draw`` that hands out ``noises`` (numpy) in order."""
  it = iter(noises)

  def draw(like):
    return torch.from_numpy(np.array(next(it))).to(like.device)

  return draw


def _pair(sde_name, continuous=True):
  jc, pc = torch_tiny.configs(TINY, torch_tiny.UNCSNPP)
  for c in (jc, pc):
    c.training.sde = sde_name
    c.model.num_scales = 10
  if sde_name == "vpsde":  # the VP score of a noise-predicting network
    jc.training.ddpm_score = pc.training.ddpm_score = True
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  jscore = jax_score_fn(jc, jsde, _JaxLinear(), {}, continuous=continuous)
  pscore = get_score_fn(pc, psde, _PortLinear(), continuous=continuous)
  return jsde, psde, jscore, pscore


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal(SHAPE).astype(np.float32)
  t = np.array([0.7, 0.2], np.float32)
  nt = np.array([0.6, 0.0], np.float32)
  return x, t, nt


CASES = [("euler_maruyama", "vpsde"), ("euler_maruyama", "reciprocal_vesde"),
         ("reverse_diffusion", "vesde"), ("reverse_diffusion", "vpsde"),
         ("reverse_diffusion", "reciprocal_vesde"),
         ("ancestral_sampling", "vesde"), ("ancestral_sampling", "vpsde"),
         ("none", "vesde")]


@pytest.mark.parametrize("name,sde_name", CASES)
def test_predictor_matches_jax(name, sde_name):
  jsde, psde, jscore, pscore = _pair(sde_name, continuous=False
                                     if name == "ancestral_sampling" else True)
  x, t, nt = _inputs()
  key = jax.random.PRNGKey(1)
  rve = sde_name == "reciprocal_vesde"
  want = jax_sampling.get_predictor(name)(
      JaxReverseSDE(jsde, jscore), x, t, key, next_t=nt if rve else None)
  got = sampling.get_predictor(name)(
      ReverseSDE(psde, pscore), torch.from_numpy(x), torch.from_numpy(t),
      _replay([jax.random.normal(key, SHAPE)]),
      next_t=torch.from_numpy(nt) if rve else None)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["langevin", "ald", "none"])
@pytest.mark.parametrize("sde_name", ["vpsde", "vesde", "reciprocal_vesde"])
def test_corrector_matches_jax(name, sde_name):
  jsde, psde, jscore, pscore = _pair(sde_name)
  x, t, _ = _inputs(seed=2)
  key, n_steps, snr = jax.random.PRNGKey(2), 2, 0.16
  noises = [jax.random.normal(k, SHAPE)
            for k in jax.random.split(key, n_steps)]
  want = jax_sampling.get_corrector(name)(jsde, jscore, x, t, key, snr,
                                          n_steps)
  got = sampling.get_corrector(name)(psde, pscore, torch.from_numpy(x),
                                     torch.from_numpy(t), _replay(noises),
                                     snr, n_steps)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)


def _jax_pc_noise(key, shape, n_steps_total, n_corrector):
  """The prior and the noise JAX's PC sampler draws from ``key``, in the
  order it draws them (reverse_diffusion + langevin)."""
  key, k_prior = jax.random.split(key)
  prior, noises = jax.random.normal(k_prior, shape), []
  for _ in range(n_steps_total):
    key, k_c, k_p = jax.random.split(key, 3)
    noises += [jax.random.normal(k, shape)
               for k in jax.random.split(k_c, n_corrector)]
    noises.append(jax.random.normal(k_p, shape))
  return prior, noises


@pytest.fixture(scope="module")
def tiny_rve():
  changes = {"data": TINY["data"], "model": dict(TINY["model"], num_scales=4)}
  return torch_tiny.build(changes, family=torch_tiny.UNCSNPP)


def test_tiny_rve_pc_run_matches_jax(tiny_rve):
  """reverse_diffusion + langevin on the reciprocal VE SDE, N = 4."""
  jc, pc, jmodel, params, pmodel = tiny_rve
  shape = torch_tiny.SHAPE
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  assert (jc.sampling.method, jc.sampling.predictor,
          jc.sampling.corrector) == ("pc", "reverse_diffusion", "langevin")
  key = jax.random.PRNGKey(3)
  jfn = jax_sampling_fn(jc, jsde, shape, jax_inv(jc),
                        jc.sampling.truncation_time)
  want, want_nfe = jax.jit(lambda p, k: jfn(jmodel, p, k))(params, key)
  prior, noises = _jax_pc_noise(key, shape, jsde.N,
                                jc.sampling.n_steps_each)
  pfn = get_sampling_fn(pc, psde, shape, get_data_inverse_scaler(pc),
                        pc.sampling.truncation_time)
  got, nfe = pfn(pmodel, x=torch.from_numpy(np.asarray(prior) * 50.0),
                 draw=_replay(noises))
  assert nfe == int(want_nfe) == 4 * 2
  assert got.shape == shape and torch.isfinite(got).all()
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())


def test_service_answers_pc(tiny_rve):
  _, pc, _, _, pmodel = tiny_rve
  service = SamplingService(pc, pmodel.state_dict(), batch=2, device="cpu",
                            max_num=8)
  assert service.meta["sampling_method"] == "pc"
  assert (service.meta["predictor"], service.meta["corrector"]) == (
      "reverse_diffusion", "langevin")
  a, nfe = service.sample(3, seed=4)  # no method: the config's, pc
  assert a.shape == (3, 16, 16, 3) and a.dtype == np.uint8
  assert nfe == 2 * 4 * 2  # two rounds of N (1 + n_steps_each)
  b, _ = service.sample(3, seed=4, method="pc")
  np.testing.assert_array_equal(a, b)
  # round 1 replayed from its prior and its own noise stream
  replay, _ = service.sampler("pc", 50)(service.model, service.noise(4, 1),
                                        x=service.prior(4, 1))
  np.testing.assert_array_equal(_to_uint8(replay).numpy()[:1], a[2:])
  # the noise stream is not the prior's
  prior_gen = torch.Generator().manual_seed(_round_seed(4, 0))
  assert not torch.equal(torch.randn(4, generator=service.noise(4, 0)),
                         torch.randn(4, generator=prior_gen))
