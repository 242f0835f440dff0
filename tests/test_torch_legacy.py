"""The port's legacy networks (soft_truncation_tpu_torch/models/{ddpm,ncsnv2,
refine}.py and the legacy blocks of layers.py) and the two vestigial
modules (models/logsnr.py, ops/fused_act.py) against the JAX package's, on
the CPU.

Each legacy network takes the reference's weights from its golden
(tests/golden/{ddpm,ncsn,ncsnv2}_golden_*.npz: the reference torch model's
state_dict, input, labels and output) through the JAX package's own
converter (``utils/torch_port.py``, as tests/test_ddpm_parity.py and
tests/test_ncsnv2_parity.py take it) into a Flax tree, then
``from_jax_params``. Its forward is held to the golden output and to JAX's
eager ``apply`` on the same input at the JAX tests' own tolerance (rtol
2e-3, atol 2e-4), and, since the DDPM goldens' zero-init output conv makes
their outputs ~1e-5 small, also within 1e-5 of the output's largest value
(the port and JAX sum the same f32 products in another order; measured
worst 1.4e-6).

The RefineNet pieces no golden reaches (``UpsampleConv``'s channel gather,
``MeanPoolConv``) and the corner-aligned resize and 5x5 pools, the LogSNR
schedule and the fused bias-act: 1e-6 (1e-5 where a conv sums) relative to
the largest value, from JAX's initialized parameters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.models import logsnr as jax_logsnr
from soft_truncation_tpu.models import refine as jax_refine
from soft_truncation_tpu.ops import fused_act as jax_fused_act
from soft_truncation_tpu.utils.torch_port import (port_ddpm_state_dict,
                                                  port_ncsnv2_state_dict)
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.models import create_model, logsnr, refine
from soft_truncation_tpu_torch.ops import fused_act
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny  # noqa: F401  (caps torch's threads)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")

_DDPM = dict(name="ddpm", nf=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), dropout=0.1, resamp_with_conv=True,
             conditional=True, nonlinearity="swish", num_scales=10,
             sigma_min=0.01, sigma_max=50.0, normalization="GroupNorm")
_NCSN = dict(nf=16, num_scales=10, sigma_min=0.01, sigma_max=50.0,
             normalization="InstanceNorm++", nonlinearity="elu")
# case: (golden file, model changes, data changes); the goldens of
# tests/test_ddpm_parity.py and tests/test_ncsnv2_parity.py
GOLDENS = {
    "ddpm-vp": ("ddpm_golden_vp.npz", dict(_DDPM, scale_by_sigma=False),
                dict(image_size=16, centered=True)),
    "ddpm-smld": ("ddpm_golden_smld.npz", dict(_DDPM, scale_by_sigma=True),
                  dict(image_size=16, centered=False)),
    "ncsn": ("ncsn_golden.npz", dict(_NCSN, name="ncsn"),
             dict(image_size=16, centered=False)),
    "ncsnv2_64": ("ncsnv2_golden_ncsnv2_64.npz",
                  dict(_NCSN, name="ncsnv2_64"),
                  dict(image_size=16, centered=False)),
    "ncsnv2_128": ("ncsnv2_golden_ncsnv2_128.npz",
                   dict(_NCSN, name="ncsnv2_128"),
                   dict(image_size=32, centered=False)),
    "ncsnv2_256": ("ncsnv2_golden_ncsnv2_256.npz",
                   dict(_NCSN, name="ncsnv2_256"),
                   dict(image_size=64, centered=False)),
}


@pytest.mark.parametrize("case", list(GOLDENS))
def test_legacy_network_matches_golden_and_jax(case):
  fname, model, data = GOLDENS[case]
  gold = np.load(os.path.join(GOLD_DIR, fname))
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  jax_override(jc, {"model": model, "data": data})
  override(pc, {"model": model, "data": data})
  sd = {k[4:]: gold[k] for k in gold.files if k.startswith("sd::")}
  porter = port_ddpm_state_dict if case.startswith("ddpm") else (
      port_ncsnv2_state_dict)
  tree = porter(sd, jc)
  pmodel = create_model(pc, "cpu")
  pmodel.load_state_dict(from_jax_params(tree))  # strict

  x = np.ascontiguousarray(np.transpose(gold["x"], (0, 2, 3, 1)))
  labels = gold["labels"] if "labels" in gold.files else gold["y_labels"]
  if case.startswith("ddpm"):  # time labels, as the DDPM score takes them
    jl, pl = jnp.asarray(labels, jnp.float32), torch.tensor(labels).float()
  else:  # integer noise-level labels
    jl, pl = jnp.asarray(labels), torch.tensor(labels)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), pl).numpy()
  jax_out = np.asarray(jax_create_model(jc).apply(
      {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(x), jl,
      train=False))
  want = np.transpose(gold["y"], (0, 2, 3, 1))
  for ref in (want, jax_out):
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["ddpm", "ncsn", "ncsnv2_64", "ncsnv2_128",
                                  "ncsnv2_256"])
def test_create_model_builds_legacy_on_cuda_by_default(name):
  pc = default_config("cifar10")
  pc.model.name = name
  pc.model.update(nf=32, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), resamp_with_conv=True,
                  conditional=True, nonlinearity="elu", scale_by_sigma=False,
                  normalization="InstanceNorm++")
  if torch.cuda.is_available():
    assert next(create_model(pc).parameters()).is_cuda
  else:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      create_model(pc)
  assert not next(create_model(pc, "cpu").parameters()).is_cuda


def _close(got, want, rel):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _nhwc(seed, shape):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def test_resize_and_pools_match_jax():
  x = _nhwc(0, (2, 5, 7, 3))
  for shape in ((9, 13), (5, 7), (3, 2), (1, 4)):
    want = np.asarray(jax_refine.bilinear_align_corners(x, shape))
    _close(refine.bilinear_align_corners(torch.from_numpy(x), shape), want,
           1e-6)
  for kind in ("max", "avg"):
    want = np.asarray(jax_refine._pool5(x, kind))
    _close(refine._pool5(torch.from_numpy(x), kind), want, 1e-6)


@pytest.mark.parametrize("name", ["UpsampleConv", "MeanPoolConv",
                                  "ConvMeanPool"])
def test_resampling_convs_match_jax(name):
  x = _nhwc(1, (2, 6, 6, 4))
  jmod = getattr(jax_refine, name)(5, 3)
  variables = jmod.init(jax.random.PRNGKey(2), x)
  want = np.asarray(jmod.apply(variables, x))
  mod = getattr(refine, name)(4, 5, 3)
  mod.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                   variables["params"])))
  _close(mod(torch.from_numpy(x)), want, 1e-5)


def test_logsnr_matches_jax():
  t = np.linspace(0.0, 1.0, 7, dtype=np.float32)
  jmod = jax_logsnr.LogSNR(mid_dim=16)
  variables = jmod.init(jax.random.PRNGKey(3), t)
  want = np.asarray(jmod.apply(variables, t))
  mod = logsnr.LogSNR(mid_dim=16)
  mod.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                   variables["params"])))
  got = mod(torch.from_numpy(t))
  _close(got, want, 1e-6)
  assert np.all(np.diff(want) > 0)  # monotone, endpoints normalized
  np.testing.assert_allclose(got.detach().numpy()[[0, -1]], [-10.0, 10.0],
                             atol=1e-4)


@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_fused_bias_act_matches_jax(act):
  x = _nhwc(4, (2, 3, 3, 5))
  b = _nhwc(5, (5,))
  for bias in (None, b):
    want = np.asarray(jax_fused_act.fused_bias_act(
        x, bias, act=act, negative_slope=0.1, scale=1.5))
    got = fused_act.fused_bias_act(
        torch.from_numpy(x), None if bias is None else torch.from_numpy(b),
        act=act, negative_slope=0.1, scale=1.5)
    _close(got, want, 1e-6)
  jmod = jax_fused_act.FusedLeakyReLU(5)
  variables = {"params": {"bias": jnp.asarray(b)}}
  mod = fused_act.FusedLeakyReLU(5)
  mod.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                   variables["params"])))
  _close(mod(torch.from_numpy(x)),
         np.asarray(jmod.apply(variables, x)), 1e-6)
  with pytest.raises(ValueError):
    fused_act.fused_bias_act(torch.from_numpy(x), act="gelu")
