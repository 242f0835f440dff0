"""The port's UNCSN++ network (FIR resampling, progressive pyramids) and its
VE / reciprocal-VE SDEs and score labels against the JAX package's, on the
CPU, with the same weights carried over by the params npz.

Tolerances: forwards at rtol 1e-4 / atol 1e-5 relative to the output's
scale (``scale_by_sigma`` makes outputs ~1/sigma large at small sigma), as
tests/test_torch_ncsnpp.py: both sides compute in f32 and sum in another
order. SDE algebra at 2e-6 (the same f32 formulas, with another pow and
exp), apart from G of ``discretize`` between adjacent times: sigma(t)^2 -
sigma(next)^2 cancels ~98% of its terms at one grid step (VE; the RVE form
uses expm1 and keeps the tight bar), and the discrete sigma grid's
log-spaced linspace differs from JAX's by an ulp of log sigma, so those
compare at 1e-4.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu.models.score import get_score_fn as jax_score_fn
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch.models import create_model, layerspp
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny
from test_torch_sampling import _JaxLinear, _PortLinear

TINY = {"data": dict(image_size=16),
        "model": dict(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(8,), init_scale=0.1)}
# the high-res configs' pyramids: FIR input skip into a 'cat' combine, and
# the FIR output skip
SKIP = {"data": TINY["data"],
        "model": dict(TINY["model"], progressive="output_skip",
                      progressive_input="input_skip",
                      progressive_combine="cat")}
# the residual output pyramid (upsample_conv_2d), with a 'sum' input skip
RESIDUAL = {"data": TINY["data"],
            "model": dict(TINY["model"], progressive="residual",
                          progressive_input="input_skip",
                          progressive_combine="sum")}
SIGMAS = np.array([0.01, 1.0, 50.0], np.float32)


@pytest.fixture(scope="module")
def tiny():
  return torch_tiny.build(TINY, batch=3, family=torch_tiny.UNCSNPP)


def _x(batch, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (batch, 16, 16, 3)).astype(np.float32)


def _close_to_scale(got, want, rtol=1e-4, atol=1e-5):
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def test_tiny_uncsnpp_forward_matches_jax(tiny):
  _, _, jmodel, params, pmodel = tiny
  x = _x(3)
  want = torch_tiny.jax_forward(jmodel, params, x, SIGMAS)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(SIGMAS)).numpy()
  _close_to_scale(got, want)
  # one FIR down (h and x) and one FIR up (h and x) per level boundary
  assert collections.Counter(pmodel.fir_sites()) == {
      ("down", 16, 16, 16): 2, ("up", 8, 8, 32): 2}


@pytest.mark.parametrize("variant", ["skip", "residual"])
def test_tiny_pyramid_variant_forward_matches_jax(variant):
  changes = SKIP if variant == "skip" else RESIDUAL
  _, _, jmodel, params, pmodel = torch_tiny.build(
      changes, batch=3, family=torch_tiny.UNCSNPP)
  x = _x(3, seed=1)
  want = torch_tiny.jax_forward(jmodel, params, x, SIGMAS)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(SIGMAS)).numpy()
  _close_to_scale(got, want)
  sites = collections.Counter(pmodel.fir_sites())
  # the input skip downsamples the 3-channel image at every level boundary
  assert sites[("down", 16, 16, 3)] == 1
  if variant == "skip":  # and the output skip upsamples the 3-channel head
    assert sites[("up", 8, 8, 3)] == 1


def test_converter_sets_every_uncsnpp_parameter(tiny):
  _, _, _, params, pmodel = tiny
  _, sd = torch_tiny.via_npz(params)
  assert len(sd) == len(jax.tree.leaves(params))
  assert set(sd) == set(pmodel.state_dict())
  assert "pyr_ds_0.conv.weight" in sd


@pytest.mark.parametrize("kind", ["down", "up"])
def test_fir_block_matches_jax(kind):
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
  temb = rng.standard_normal((2, 64)).astype(np.float32)
  jblock = jax_layerspp.ResnetBlockBigGANpp(
      act=jax.nn.silu, out_ch=16, up=kind == "up", down=kind == "down",
      fir=True, fir_kernel=(1, 3, 3, 1), init_scale=0.1)
  params = jax.jit(lambda k: jblock.init(k, x, temb, False))(
      jax.random.PRNGKey(1))["params"]
  want = np.asarray(jax.jit(lambda p: jblock.apply({"params": p}, x, temb,
                                                   False))(params))
  pblock = layerspp.ResnetBlockBigGANpp(
      torch.nn.functional.silu, 16, 16, temb_dim=64, up=kind == "up",
      down=kind == "down", fir=True, init_scale=0.1)
  pblock.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
  with torch.no_grad():
    got = pblock(torch.from_numpy(x), torch.from_numpy(temb)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
  assert pblock.last_fir_sites == [(kind, 8, 8, 16)] * 2


def _sdes(name):
  jc, pc = torch_tiny.configs(TINY, torch_tiny.UNCSNPP)
  for c in (jc, pc):
    c.training.sde = name
  return jax_get_sde(jc), get_sde(pc)


def _close(got, want, rtol=1e-6, atol=1e-6):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol)


@pytest.mark.parametrize("name", ["vesde", "reciprocal_vesde"])
def test_ve_sdes_match_jax(name):
  jsde, psde = _sdes(name)
  assert type(psde).__name__ == type(jsde).__name__
  rng = np.random.default_rng(0)
  x = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
  # a grid pair one step apart, the last step (next_t = 0), far pairs
  t = np.array([1e-5, 0.37, 1.0, 0.5, 2e-3], np.float32)
  nt = np.array([0.0, 0.3, 1.0 - 1.0 / 999, 0.5 - 1.0 / 999, 1e-5],
                np.float32)
  px, pt, pnt = map(torch.from_numpy, (x, t, nt))
  for jout, pout in ((jsde.sde(x, t), psde.sde(px, pt)),
                     (jsde.marginal_prob(x, t), psde.marginal_prob(px, pt))):
    for j, p in zip(jout, pout):
      _close(p, j, rtol=2e-6)
  for j, p in zip(jsde.discretize(x, t, nt), psde.discretize(px, pt, pnt)):
    _close(p, j, rtol=2e-6 if name == "reciprocal_vesde" else 1e-4)
  _close(psde.marginal_std(pt), jsde.marginal_std(t))
  _close(psde.prior_logp(px), jsde.prior_logp(x), atol=1e-3)
  if name == "vesde":  # the discrete sigma grid
    _close(psde.discrete_sigmas(), jsde.discrete_sigmas(), rtol=1e-6)
    for j, p in zip(jsde.discretize(x, t), psde.discretize(px, pt)):
      _close(p, j, rtol=1e-4)
  else:
    with pytest.raises(ValueError, match="next_t"):
      psde.discretize(px, pt)


@pytest.mark.parametrize("name", ["vesde", "reciprocal_vesde"])
@pytest.mark.parametrize("continuous", [True, False])
def test_ve_score_labels_match_jax(name, continuous):
  """The VE / RVE score is the network's output at sigma(t) labels
  (continuous) or round((T-t)(N-1)) (discrete)."""
  jc, pc = torch_tiny.configs(TINY, torch_tiny.UNCSNPP)
  for c in (jc, pc):
    c.training.sde = name
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  rng = np.random.default_rng(1)
  x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
  t = np.array([1e-3, 0.37, 1.0], np.float32)
  want = jax_score_fn(jc, jsde, _JaxLinear(), {}, continuous=continuous)(x, t)
  got = get_score_fn(pc, psde, _PortLinear(), continuous=continuous)(
      torch.from_numpy(x), torch.from_numpy(t))
  _close(got, want)


def test_out_of_slice_pyramid_without_fir_raises():
  """The pyramids without FIR are ported (their forward is held to JAX by
  tests/test_torch_configs.py::test_variant_forward_matches_jax
  [pyramids_without_fir]): UNCSN++ with fir=False builds and runs no FIR
  site; a pyramid mode JAX does not know still raises."""
  _, pc = torch_tiny.configs(TINY, torch_tiny.UNCSNPP)
  pc.model.fir = False
  model = create_model(pc, "cpu")
  with torch.no_grad():
    model(torch.zeros(torch_tiny.SHAPE), torch.ones(2))
  assert model.fir_sites() == []
  pc.model.progressive = "skip"
  with pytest.raises(ValueError, match="progressive"):
    create_model(pc, "cpu")
