"""The port's discrete training (``training.continuous=False``): the SMLD and
DDPM losses (soft_truncation_tpu_torch/losses/losses.py) and the train
step's routing (train/step.py) against the JAX package's, on the CPU.

The JAX functions draw with their keys; the port is handed those numbers
through ``draw``, in JAX's order: per micro-batch the integer labels
(``draw('label', (b,), N)``), then the noise.

Tolerances:
- the losses of a stand-in network (x * 0.5 + labels / 1000): DDPM's 1e-6
  relative, the same f32 formulas; SMLD's 1e-5, as its sigmas come from a
  log-spaced grid whose ``linspace`` differs from JAX's by an ulp of log
  sigma (tests/test_torch_uncsnpp.py);
- one train step of a tiny DDPM (nf 32, 8x8, one level, dropout 0,
  learning rate 0 at the first update as optax's warmup gives it): losses 1e-5 relative, Adam's first moment (0.1 of the summed
  gradients) per tensor within 1e-3 of its largest value (at least 1e-6 of
  the step's largest), the bars of tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.losses.losses import (
    get_ddpm_loss_fn as jax_ddpm_loss, get_smld_loss_fn as jax_smld_loss)
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.train import make_train_step as jax_make_train_step
from soft_truncation_tpu.train.state import TrainState as JaxTrainState
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.losses import make_draw
from soft_truncation_tpu_torch.losses.losses import (get_ddpm_loss_fn,
                                                     get_smld_loss_fn)
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.train import init_train_state, make_train_step
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny

BATCH = 4


def _pair(sde, **training):
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  changes = {"training": dict(sde=sde, continuous=False,
                              likelihood_weighting=False, st=False,
                              **training),
             "model": dict(num_scales=10, sigma_min=0.01, sigma_max=50.0)}
  jax_override(jc, changes)
  override(pc, changes)
  return jc, pc


class _JaxLinear:
  """A stand-in network whose output depends on the labels."""

  def apply(self, variables, x, labels, train=False, rngs=None):
    return x * 0.5 + labels.reshape(-1, 1, 1, 1) / 1000.0


class _PortLinear(torch.nn.Module):

  def forward(self, x, labels, train=False, generator=None):
    return x * 0.5 + labels.reshape(-1, 1, 1, 1) / 1000.0


def _discrete_draws(key, b, shape, n):
  """What JAX's discrete losses draw from ``key``: labels, then noise."""
  k_label, k_noise = jax.random.split(key)
  return [("label", jax.random.randint(k_label, (b,), 0, n), n),
          ("normal", jax.random.normal(k_noise, shape), None)]


def _replay(draws):
  it = iter(draws)

  def draw(kind, shape, high=None):
    want_kind, value, want_high = next(it)
    assert (kind, tuple(shape), high) == (want_kind, tuple(value.shape),
                                          want_high)
    return torch.from_numpy(np.array(value)).to(
        torch.int64 if kind == "label" else torch.float32)

  draw.left = it
  return draw


def _batch(seed, shape=(BATCH, 8, 8, 3)):
  return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("reduce_mean", [True, False])
@pytest.mark.parametrize("kind", ["smld", "ddpm"])
def test_discrete_loss_matches_jax(kind, reduce_mean):
  jc, pc = _pair("vesde" if kind == "smld" else "vpsde",
                 reduce_mean=reduce_mean)
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  batch, key = _batch(1), jax.random.PRNGKey(2)
  jfn = (jax_smld_loss if kind == "smld" else jax_ddpm_loss)(jc, jsde, True)
  want = np.asarray(jfn({}, _JaxLinear(), batch, key))
  draw = _replay(_discrete_draws(key, BATCH, batch.shape, psde.N))
  pfn = (get_smld_loss_fn if kind == "smld" else get_ddpm_loss_fn)(
      pc, psde, True)
  got = pfn(_PortLinear(), torch.from_numpy(batch), draw).numpy()
  assert next(draw.left, None) is None
  np.testing.assert_allclose(got, want, rtol=1e-5 if kind == "smld" else
                             1e-6)


def test_discrete_routing_refuses_what_jax_refuses():
  jc, pc = _pair("vesde")
  with pytest.raises(ValueError):  # SMLD takes a VE SDE only
    get_smld_loss_fn(pc, get_sde(_pair("vpsde")[1]), True)
  with pytest.raises(ValueError):
    get_ddpm_loss_fn(pc, get_sde(pc), True)
  pc.training.likelihood_weighting = True
  with pytest.raises(ValueError, match="Likelihood weighting"):
    make_train_step(pc, get_sde(pc))
  pc.training.likelihood_weighting = False
  pc.training.sde = "subvpsde"
  with pytest.raises(ValueError, match="not recommended"):
    make_train_step(pc, get_sde(pc))
  # the label kind of make_draw: int64 in [0, high)
  labels = make_draw(torch.Generator().manual_seed(0), "cpu")(
      "label", (64,), 10)
  assert labels.dtype == torch.int64 and 0 <= labels.min() and (
      labels.max() < 10)


TINY_DDPM = {"model": dict(name="ddpm", nf=32, ch_mult=(1,),
                           num_res_blocks=1, attn_resolutions=(8,),
                           dropout=0.0, resamp_with_conv=True,
                           conditional=True, nonlinearity="swish",
                           scale_by_sigma=False, ema_rate=0.9999),
             "data": dict(image_size=8, centered=True),
             "optim": dict(num_micro_batch=1, warmup=1, lr=1e-3)}


def test_ddpm_train_step_matches_jax():
  jc, pc = _pair("vpsde", reduce_mean=True)
  jax_override(jc, TINY_DDPM)
  override(pc, TINY_DDPM)
  pc.model.num_scales = jc.model.num_scales = 1000
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  pmodel = create_model(pc, "cpu", seed=0)
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():  # signal in the zero-init convs too
    for p in pmodel.parameters():
      if p.abs().max() < 1e-6 and p.dim() > 1:
        p.normal_(0.0, 0.02, generator=gen)
  jmodel = jax_create_model(jc)
  x = np.zeros((1, 8, 8, 3), np.float32)
  template = jax.eval_shape(
      lambda k: jmodel.init({"params": k}, x, np.zeros(1, np.float32),
                            train=False), jax.random.PRNGKey(0))["params"]
  params = torch_tiny.to_jax_params(pmodel.state_dict(), template)
  tx = jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params),
                        ema_params=jax.tree.map(jnp.array, params),
                        ema_rate=float(jc.model.ema_rate))
  batch, key = 2.0 * _batch(3) - 1.0, jax.random.PRNGKey(4)
  state, want = jax.jit(jax_make_train_step(jc, jsde, jmodel, tx))(
      state, batch, key)

  # JAX's draws: no t_min (Soft-Truncation off), then the loss's
  _, k_loss, _ = jax.random.split(key, 3)
  draw = _replay(_discrete_draws(k_loss, BATCH, batch.shape, psde.N))
  pstate = init_train_state(pc, pmodel)
  got = make_train_step(pc, psde)(pstate, torch.from_numpy(batch),
                                  torch.Generator(), draw)
  assert next(draw.left, None) is None
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
  adam = next(s for s in state.opt_state if hasattr(s, "mu"))
  jax_mu = from_jax_params(jax.tree.map(np.asarray, adam.mu))
  names = [n for n, p in pmodel.named_parameters() if p.requires_grad]
  assert len(names) == len(jax_mu) > 30
  # a tensor whose true gradient is zero (a bias that a GroupNorm removes)
  # holds rounding only: its bar is at least 1e-6 of the largest gradient
  floor = 1e-6 * max(m.abs().max().item() for m in jax_mu.values())
  for name, mu in zip(names, pstate.optimizer.mu):
    ref = jax_mu[name]
    scale = max(ref.abs().max().item(), floor)
    assert (mu - ref).abs().max().item() <= 1e-3 * scale, name


LEGACY_CLI = {
    "ddpm": ["--config.training.sde=vpsde", "--config.model.name=ddpm",
             "--config.model.nf=32", "--config.model.ch_mult=(1,)",
             "--config.model.attn_resolutions=(8,)",
             "--config.training.reduce_mean=True"],
    "ncsnv2_64": ["--config.training.sde=vesde",
                  "--config.model.name=ncsnv2_64", "--config.model.nf=8",
                  "--config.model.normalization=InstanceNorm++",
                  "--config.model.nonlinearity=elu",
                  "--config.model.scale_by_sigma=True",
                  "--config.model.num_scales=232",
                  "--config.model.sigma_min=0.01"],
}


@pytest.mark.parametrize("name", sorted(LEGACY_CLI))
def test_cli_trains_a_legacy_model_discretely(tmp_path, name):
  """``main --mode train`` (``run_lib.train``) on a legacy network with
  ``training.continuous=False``, as the public configs train them."""
  import os
  import re

  from soft_truncation_tpu_torch import main as port_main
  port_main.main([
      "--config", os.path.join(torch_tiny.PORT_CONFIGS, "vp", "CIFAR10",
                               "ddpmpp_nll_st.py"),
      "--workdir", str(tmp_path), "--mode", "train", "--cpu",
      "--config.training.continuous=False", "--config.training.st=False",
      "--config.training.likelihood_weighting=False",
      "--config.training.n_iters=2", "--config.training.log_freq=1",
      "--config.training.batch_size=4", "--config.data.image_size=8",
      "--config.data.dataset=Synthetic", "--config.model.num_res_blocks=1",
      "--config.training.snapshot_freq_for_preemption=2",
      *LEGACY_CLI[name]])
  line = re.compile(r"step: (\d+), training loss mean: ([^,]+),")
  with open(tmp_path / "stdout.txt") as f:
    logged = [m.groups() for m in map(line.search, f) if m]
  assert [int(s) for s, _ in logged] == [0, 1, 2]
  assert all(np.isfinite(float(v)) for _, v in logged)
  assert os.listdir(tmp_path / "checkpoints-meta") == ["checkpoint"]
