"""The port's parallel-in-time (Picard) samplers (soft_truncation_tpu_torch/
sample/parallel.py) on the CPU.

With ``picard_tol = 0`` the Picard fixed point is the sequential chain:
from the same prior and the same generator, ``picard`` must give the
sample of the port's ``pc`` and ``picard_dpm`` that of its ``dpm_solver``,
at the JAX package's bar for the same property (rtol = atol = 1e-4,
tests/test_picard_parallel.py), on the same kind of tiny network. Then the
Langevin step size per window position, the stochastic-chain guard, the
nfe accounting, ``sampling.chunk``, and one run against the JAX package's
``get_picard_pc_sampler`` with its noise handed to the port.
"""

import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inv
from soft_truncation_tpu.sample import get_sampling_fn as jax_sampling_fn
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.sample import get_sampling_fn, sampling
from soft_truncation_tpu_torch.sde import get_sde

import torch_tiny
from test_torch_pc import _jax_pc_noise, _replay
from test_torch_sampling import _JaxLinear, _PortLinear

SHAPE = (2, 8, 8, 3)
EXACT = dict(rtol=1e-4, atol=1e-4)


def _config(sde="vesde", predictor="reverse_diffusion", corrector="langevin",
            n_steps_each=1, num_scales=8, probability_flow=False, **sampling):
  """The JAX package's Picard test network: NCSN++ at nf 8, 8x8, one
  res-block per level (init_scale 0.1, so that every conv carries
  signal)."""
  config = default_config("cifar10")
  override(config, {
      "training": dict(sde=sde, continuous=True, eta=1e-6,
                       truncation_time=1e-3),
      "data": dict(image_size=8, centered=False),
      "sampling": dict(method="pc", predictor=predictor, corrector=corrector,
                       snr=0.16, n_steps_each=n_steps_each,
                       probability_flow=probability_flow, noise_removal=True,
                       **sampling),
      "model": dict(
          name="ncsnpp", scale_by_sigma=sde != "vpsde", ema_rate=0.999,
          normalization="GroupNorm", nonlinearity="swish", nf=8,
          ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
          resamp_with_conv=True, conditional=True, fir=False,
          fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type="biggan",
          progressive="none", progressive_input="none",
          progressive_combine="sum", init_scale=0.1, embedding_type="fourier",
          fourier_scale=16, num_scales=num_scales, dropout=0.0),
  })
  return config


_MODELS = {}


def _model(config):
  key = config.model.scale_by_sigma
  if key not in _MODELS:
    _MODELS[key] = create_model(config, "cpu", seed=0)
  return _MODELS[key]


def _sample(config, method, seed=7, **sampling_keys):
  """``method``'s sample and nfe from the prior and noise of ``seed``."""
  config.sampling.method = method
  for k, v in sampling_keys.items():
    config.sampling[k] = v
  sde = get_sde(config)
  fn = get_sampling_fn(config, sde, SHAPE, get_data_inverse_scaler(config),
                       config.sampling.truncation_time)
  gen = torch.Generator().manual_seed(seed)
  samples, nfe = fn(_model(config), gen)
  return samples.numpy(), nfe, fn


PC_CASES = {
    "ve_langevin": dict(),
    "vp_euler_maruyama": dict(sde="vpsde", predictor="euler_maruyama",
                              corrector="none"),
    # the VP grid's discrete betas stay below 1 from N = 21 on
    "vp_ancestral": dict(sde="vpsde", predictor="ancestral_sampling",
                         corrector="none", num_scales=24),
    "rve_langevin": dict(sde="reciprocal_vesde"),
    "rve_window_not_dividing_n": dict(sde="reciprocal_vesde", num_scales=10),
    "ve_two_corrector_steps": dict(n_steps_each=2),
    "vp_probability_flow": dict(sde="vpsde", corrector="none",
                                probability_flow=True, num_scales=24),
}


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_picard_at_tol_0_is_the_sequential_pc_sample(case):
  want, seq_nfe, _ = _sample(_config(**PC_CASES[case]), "pc")
  got, nfe, fn = _sample(_config(**PC_CASES[case]), "picard",
                         picard_window=4, picard_tol=0.0)
  assert np.isfinite(want).all()
  np.testing.assert_allclose(got, want, **EXACT)
  n_steps = PC_CASES[case].get("n_steps_each", 1)
  n = PC_CASES[case].get("num_scales", 8)
  assert seq_nfe == n * (n_steps + 1)
  # at most W sweeps per block of W positions: at most W x the sequential
  assert nfe <= 4 * seq_nfe and fn.last_sweeps <= 4 * -(-n // 4)
  if n % 4 == 0:
    assert nfe == fn.last_sweeps * 4 * (n_steps + 1)


@pytest.mark.parametrize("sde,window", [("vpsde", 0), ("vpsde", 4),
                                        ("reciprocal_vesde", 0),
                                        ("reciprocal_vesde", 3)])
def test_picard_dpm_at_tol_0_is_the_sequential_dpm_sample(sde, window):
  want, seq_nfe, _ = _sample(_config(sde=sde), "dpm_solver", dpm_steps=6)
  got, nfe, fn = _sample(_config(sde=sde), "picard_dpm", dpm_steps=6,
                         picard_window=window, picard_tol=0.0)
  np.testing.assert_allclose(got, want, **EXACT)
  assert seq_nfe == 7
  if window == 0:  # one block of 6 positions, plus the denoising evaluation
    assert nfe == fn.last_sweeps * 6 + 1 and fn.last_sweeps <= 6


def test_picard_dpm_nfe_counts_the_sweeps_it_ran():
  """A tolerance every sweep passes stops each block after one sweep."""
  _, nfe, fn = _sample(_config(sde="vpsde"), "picard_dpm", dpm_steps=6,
                       picard_window=4, picard_tol=1e9)
  assert fn.last_sweeps == 2 and nfe == 6 + 1
  # a sweep cap below the window bounds every block
  _, nfe, fn = _sample(_config(sde="vpsde"), "picard_dpm", dpm_steps=6,
                       picard_window=0, picard_tol=0.0, picard_max_sweeps=2)
  assert fn.last_sweeps == 2 and nfe == 2 * 6 + 1


def test_chunk_runs_the_same_blocks():
  """``sampling.chunk`` 3 at window 4 runs segments of one window each: the
  same sample, bit for bit, as one segment."""
  kw = dict(sde="reciprocal_vesde", num_scales=10)
  want, nfe, _ = _sample(_config(**kw), "picard", picard_window=4,
                         picard_tol=0.0)
  got, chunked_nfe, _ = _sample(_config(**kw), "picard", picard_window=4,
                                picard_tol=0.0, chunk=3)
  np.testing.assert_array_equal(got, want)
  assert chunked_nfe == nfe


def test_langevin_step_size_is_per_window_position():
  """At ``positions=3`` the corrector equals three separate calls, one per
  position's batch: the step size's norms are averaged per position."""
  config = _config()
  sde = get_sde(config)
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.standard_normal((6, 4, 4, 3)).astype(np.float32))
  x[2:4] *= 5.0  # positions of different scales
  t = torch.tensor([0.9, 0.9, 0.5, 0.5, 0.2, 0.2])
  noise = torch.from_numpy(
      rng.standard_normal((2, 6, 4, 4, 3)).astype(np.float32))

  def score_fn(x, t):
    return -x * (1.0 + t)[:, None, None, None]

  langevin = sampling.get_corrector("langevin")
  got = langevin(sde, score_fn, x, t, _replay(list(noise.numpy())), 0.16, 2,
                 positions=3)
  for p in range(3):
    rows = slice(2 * p, 2 * p + 2)
    want = langevin(sde, score_fn, x[rows], t[rows],
                    _replay([n[rows].numpy() for n in noise]), 0.16, 2)
    for g, w in zip(got, want):
      torch.testing.assert_close(g[rows], w, rtol=1e-6, atol=1e-6)
  whole = langevin(sde, score_fn, x, t, _replay(list(noise.numpy())), 0.16, 2)
  assert not torch.allclose(whole[0], got[0])


def test_tol_above_0_on_a_stochastic_chain_raises():
  """The base config's picard_tol (1e-3) on a PC chain with noise raises,
  as in the JAX package; ``picard_unsafe_tol`` opts in; a deterministic
  chain (probability flow, no corrector) takes the tolerance."""
  config = _config()
  assert config.sampling.picard_tol == 1e-3
  with pytest.raises(ValueError, match="stochastic chain"):
    _sample(config, "picard")
  _, nfe, _ = _sample(_config(), "picard", picard_unsafe_tol=True,
                      picard_window=4)
  assert nfe > 0
  _, nfe, _ = _sample(_config(corrector="none", probability_flow=True),
                      "picard", picard_window=4)
  assert 0 < nfe <= 8 * 2 * 4


def test_picard_matches_jax_with_its_noise():
  """tol = 0 on the linear stand-in network (reverse diffusion + Langevin,
  reciprocal VE, N = 6, window 4: a full block and a tail): the JAX
  package's Picard sampler from a key, and the port's from the prior and
  noise that key draws."""
  jc, pc = torch_tiny.configs(torch_tiny.TINY, torch_tiny.UNCSNPP)
  shape = (2, 4, 4, 3)
  for c in (jc, pc):
    c.model.num_scales = 6
    c.sampling.method = "picard"
    c.sampling.picard_window = 4
    c.sampling.picard_tol = 0.0
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  key = jax.random.PRNGKey(5)
  jfn = jax_sampling_fn(jc, jsde, shape, jax_inv(jc),
                        jc.sampling.truncation_time)
  want, want_nfe = jax.jit(lambda k: jfn(_JaxLinear(), {}, k))(key)
  prior, noises = _jax_pc_noise(key, shape, 6, 1)
  pfn = get_sampling_fn(pc, psde, shape, get_data_inverse_scaler(pc),
                        pc.sampling.truncation_time)
  got, nfe = pfn(_PortLinear(), x=torch.from_numpy(
      np.asarray(prior) * np.float32(pc.model.sigma_max)),
                 draw=_replay(noises))
  assert nfe == int(want_nfe)
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())


def test_the_server_serves_picard():
  """``method`` 'picard_dpm' through the SamplingService: the same bytes per
  seed, nfe as measured; 'picard' with the config's picard_tol on a
  stochastic chain is refused as the sampler refuses it."""
  from soft_truncation_tpu_torch.serve.server import SamplingService
  config = _config(sde="vpsde")
  service = SamplingService(config, _model(config).state_dict(), batch=2,
                            device="cpu", max_num=4)
  assert "picard_dpm" in service.meta["methods"]
  a, nfe = service.sample(3, seed=1, method="picard_dpm", dpm_steps=4)
  b, nfe_b = service.sample(3, seed=1, method="picard_dpm", dpm_steps=4)
  np.testing.assert_array_equal(a, b)
  assert a.shape == (3, 8, 8, 3) and a.dtype == np.uint8
  assert nfe == nfe_b and 2 * (4 + 1) <= nfe <= 2 * (4 * 4 + 1)
  with pytest.raises(ValueError, match="stochastic chain"):
    service.sample(2, seed=1, method="picard")
