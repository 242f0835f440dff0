"""The port's DDPM++ network (soft_truncation_tpu_torch/models/) against the
JAX package's, with the same weights carried over by the params npz.

Tolerances: rtol 1e-4 / atol 1e-5 for eval forwards. Both sides compute in
f32; the port sums convolutions and GroupNorm statistics in another order,
and at the fused sites it applies the GroupNorm folded into one scale and
shift (as the JAX kernel does) where the JAX eval path normalises first.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu_torch.models import layerspp
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny


@pytest.fixture(scope="module")
def tiny():
  return torch_tiny.build()


def _x_t(batch, size, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
  t = np.array([5.0, 640.5, 999.0][:batch], np.float32)
  return x, t


def test_tiny_forward_matches_jax(tiny):
  _, _, jmodel, params, pmodel = tiny
  x, t = _x_t(2, 16)
  want = torch_tiny.jax_forward(jmodel, params, x, t)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


VARIANTS = {
    # the other flagship options: Fourier embedding of sigma labels,
    # scale_by_sigma, inputs in [0, 1]
    "fourier_sigma_uncentered": dict(embedding_type="fourier",
                                     scale_by_sigma=True),
    # positional labels with scale_by_sigma, no time conditioning
    "positional_sigma_unconditional": dict(scale_by_sigma=True,
                                           conditional=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiny_variant_forward_matches_jax(variant):
  changes = {"data": dict(torch_tiny.TINY["data"], centered=False),
             "model": dict(torch_tiny.TINY["model"], **VARIANTS[variant])}
  _, _, jmodel, params, pmodel = torch_tiny.build(changes)
  x, t = _x_t(2, 16)
  if variant.startswith("fourier"):
    t = np.array([0.02, 37.0], np.float32)  # sigma labels
  want = torch_tiny.jax_forward(jmodel, params, x, t)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tiny_forward_fuses_every_eligible_site(tiny):
  """2 fused sites per plain res-block, 1 per up/down block (norm1->conv1)."""
  _, pc, _, _, pmodel = tiny
  x, t = _x_t(2, 16)
  with torch.no_grad():
    pmodel(torch.from_numpy(x), torch.from_numpy(t))
  levels, blocks = len(pc.model.ch_mult), pc.model.num_res_blocks
  plain = levels * blocks + 2 + levels * (blocks + 1)
  assert len(pmodel.fused_sites()) == 2 * plain + 2 * (levels - 1)


def test_converter_consumes_every_leaf_and_sets_every_parameter(tiny):
  _, pc, _, params, pmodel = tiny
  tree, sd = torch_tiny.via_npz(params)
  assert len(sd) == len(jax.tree.leaves(params))
  assert set(sd) == set(pmodel.state_dict())
  for k, v in pmodel.state_dict().items():
    assert v.shape == sd[k].shape, k

  extra = dict(tree, bogus_block={"kernel": np.zeros((3, 3, 1, 1))})
  with pytest.raises(RuntimeError, match="bogus_block"):
    pmodel.load_state_dict(from_jax_params(extra))
  missing = {k: v for k, v in tree.items() if k != "out_conv"}
  with pytest.raises(RuntimeError, match="out_conv"):
    pmodel.load_state_dict(from_jax_params(missing))
  unknown = dict(tree, stem=dict(tree["stem"], gain=np.ones(3)))
  with pytest.raises(ValueError, match="stem/gain"):
    from_jax_params(unknown)


def test_fused_conv_weight_is_transposed_once_per_weight_value():
  from soft_truncation_tpu_torch.models.layers import DDPMConv
  from soft_truncation_tpu_torch.ops import gn_conv
  gen = torch.Generator().manual_seed(0)
  conv = DDPMConv(4, 6, 3)
  conv.reset_parameters(gen)
  first = conv.weight_hwio()
  split = conv.weight_tf32_split()
  assert conv.weight_hwio() is first and conv.weight_tf32_split() is split
  assert first.is_contiguous() and first.shape == (3, 3, 4, 6)
  assert torch.equal(first, conv.weight.detach().permute(2, 3, 1, 0))
  assert all(torch.equal(a, b) for a, b in zip(
      split, gn_conv.weight_operand(first)))
  new = torch.randn(6, 4, 3, 3, generator=gen)
  conv.load_state_dict({"weight": new, "bias": torch.zeros(6)})
  again = conv.weight_hwio()
  assert again is not first
  assert torch.equal(again, new.permute(2, 3, 1, 0))
  assert all(torch.equal(a, b) for a, b in zip(
      conv.weight_tf32_split(), gn_conv.weight_operand(again)))


def _jax_block(kind):
  if kind == "attn":
    return jax_layerspp.AttnBlockpp(skip_rescale=True, init_scale=0.1)
  return jax_layerspp.ResnetBlockBigGANpp(
      act=jax.nn.silu, out_ch=32 if kind == "plain" else 16,
      up=kind == "up", down=kind == "down", init_scale=0.1)


def _port_block(kind):
  if kind == "attn":
    return layerspp.AttnBlockpp(16, skip_rescale=True, init_scale=0.1)
  return layerspp.ResnetBlockBigGANpp(
      F.silu, 16, 32 if kind == "plain" else 16, temb_dim=64,
      up=kind == "up", down=kind == "down", init_scale=0.1)


@pytest.mark.parametrize("kind", ["plain", "up", "down", "attn"])
def test_block_matches_jax(kind):
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
  temb = rng.standard_normal((2, 64)).astype(np.float32)
  jblock = _jax_block(kind)
  args = (x,) if kind == "attn" else (x, temb, False)
  params = jax.jit(lambda k: jblock.init(k, *args))(
      jax.random.PRNGKey(1))["params"]
  want = np.asarray(jax.jit(lambda p: jblock.apply({"params": p}, *args))(
      params))

  pblock = _port_block(kind)
  pblock.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
  with torch.no_grad():
    if kind == "attn":
      got = pblock(torch.from_numpy(x))
    else:
      got = pblock(torch.from_numpy(x), torch.from_numpy(temb))
      assert len(pblock.last_fused_sites) == (2 if kind == "plain" else 1)
  assert got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_out_of_slice_options_raise():
  """Every NCSN++ option builds, and so do the legacy networks and the
  discrete losses (slice 6b) and the Picard samplers (slice 6c), whose
  stochastic-chain guard refuses the base config's tolerance on a PC
  chain; what is still out of the port (the 2-D data x space mesh)
  raises."""
  from soft_truncation_tpu_torch.models import create_model, ddpm
  from soft_truncation_tpu_torch.sample.sampling import get_sampling_fn
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import make_train_step
  for section, key, value in (("model", "fourier_feature", True),
                              ("model", "resblock_type", "ddpm"),
                              ("model", "progressive", "output_skip"),
                              ("model", "auxiliary_resblock", False),
                              ("model", "lsgm", True)):
    _, pc = torch_tiny.configs()  # fir=False
    pc[section][key] = value
    create_model(pc, "cpu")
  _, pc = torch_tiny.configs()
  pc.model.update(name="ddpm", nf=32)
  assert isinstance(create_model(pc, "cpu"), ddpm.DDPM)
  _, pc = torch_tiny.configs()
  pc.training.update(continuous=False, likelihood_weighting=False)
  make_train_step(pc, get_sde(pc))  # the discrete DDPM loss of a VP SDE
  pc.sampling.method = "picard"
  with pytest.raises(ValueError, match="stochastic chain"):
    get_sampling_fn(pc, get_sde(pc), torch_tiny.SHAPE, lambda x: x, 1e-3)
  pc.sampling.method = "picard_dpm"
  get_sampling_fn(pc, get_sde(pc), torch_tiny.SHAPE, lambda x: x, 1e-3)
  from soft_truncation_tpu_torch.parallel import ddp
  pc.tpu.mesh_shape = (1, 1)
  with pytest.raises(NotImplementedError, match="space"):
    ddp.check_mesh(pc, ddp.World())


@pytest.mark.slow
def test_flagship_forward_matches_jax_full_width():
  """Full-width flagship (nf 128, 4 levels x 4 res-blocks), batch 1, at the
  bar of tests/test_ncsnpp_parity.py (rtol 2e-3 / atol 2e-4)."""
  _, _, jmodel, params, pmodel = torch_tiny.build(torch_tiny.FULL, batch=1)
  x, t = _x_t(1, 32)
  want = torch_tiny.jax_forward(jmodel, params, x, t)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
  np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
  assert len(pmodel.fused_sites()) == 82
