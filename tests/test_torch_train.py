"""The parts of the port's training path (soft_truncation_tpu_torch/{sde,
losses,models}/) against the JAX package's, on the CPU, with the same
weights: the time samplers, the optimizer, the EMA, dropout in the training
forward and the per-example losses. The whole step is in
tests/test_torch_train_step.py.

Random numbers: JAX's functions run with their own keys; the port is handed
the numbers those keys draw, in the order JAX draws them (the ``draw`` hook
of the port's loss and step): t's uniforms, z, the reconstruction's z, and
the step's ``t_min`` uniform. Dropout runs at rate 0 in the whole-step and
loss tests; one block test hands both sides the same mask.

Tolerances:
- samplers and the EMA: 2e-6 relative, the same f32 formulas through
  exp/log/sqrt/pow, each within an ulp or two of the other's;
- the optimizer on given gradients: rtol 1e-5 / atol 1e-7, the bar of
  tests/test_optimizer_parity.py;
- per-example losses: 1e-5 relative (the forwards agree to ~1e-6 of their
  scale, test_torch_ncsnpp.py; the losses sum their squares), 1e-4 with the
  discretized Gaussian decoder: it takes log(cdf(x + 1/255) - cdf(x -
  1/255)), two f32 values that cancel to ~1e-2 of their size, so an ulp of
  tanh (evaluated differently by XLA and torch) moves each term ~1e-5;
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.losses import get_sde_loss_fn as jax_get_loss_fn
from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu.models.ema import ema_update as jax_ema_update
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.sde.core import st_active_for as jax_st_active_for
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.losses import Optimizer, get_sde_loss_fn
from soft_truncation_tpu_torch.models import layerspp
from soft_truncation_tpu_torch.models import dropout as port_dropout
from soft_truncation_tpu_torch.models.ema import ema_update
from soft_truncation_tpu_torch.sde import get_sde, st_active_for
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny

TINY = {"data": dict(image_size=16),
        "model": dict(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(8,), init_scale=0.1, dropout=0.0)}
BATCH = 4


def _close(got, want, rtol=2e-6, atol=0.0, **kw):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol, **kw)


# ---------------------------------------------------------------------------
# diffusion-time samplers
# ---------------------------------------------------------------------------


def _sde_pair(name, **training):
  jc, pc = torch_tiny.configs(TINY, torch_tiny.UNCSNPP)
  for c in (jc, pc):
    c.training.sde = name
    c.training.update(training)
  return jc, pc, jax_get_sde(jc), get_sde(pc)


@pytest.mark.parametrize("name,importance_sampling", [
    ("vpsde", True), ("vpsde", False), ("vesde", True),
    ("reciprocal_vesde", True), ("reciprocal_vesde", False)])
def test_sample_diffusion_time_matches_jax(name, importance_sampling):
  _, _, jsde, psde = _sde_pair(name)
  key, t_min = jax.random.PRNGKey(5), np.float32(3e-3)
  t, Z = jsde.sample_diffusion_time(key, 64, jnp.asarray(t_min),
                                    importance_sampling)
  u = np.asarray(jax.random.uniform(key, (64,)))
  pt, pZ = psde.sample_diffusion_time(torch.tensor(u),
                                      torch.tensor(t_min),
                                      importance_sampling)
  _close(pt, t)
  _close(pZ, Z)
  assert (pt >= t_min * (1 - 1e-6)).all() and (pt <= 1.0).all()


@pytest.mark.parametrize("name,k", [("vpsde", 1.0), ("vpsde", 2.0),
                                    ("vesde", 0.5),
                                    ("reciprocal_vesde", 1.0)])
def test_sample_t_min_matches_jax(name, k):
  _, _, jsde, psde = _sde_pair(name)
  for seed in range(4):
    key = jax.random.PRNGKey(seed)
    want = jsde.sample_t_min(key, k, 1e-5)
    u = np.asarray(jax.random.uniform(key, ()))
    _close(psde.sample_t_min(torch.tensor(u), k, 1e-5), want)


@pytest.mark.parametrize("name", ["vpsde", "vesde", "reciprocal_vesde"])
@pytest.mark.parametrize("quirk", [False, True])
def test_st_active_for_matches_jax(name, quirk):
  for st in (True, False):
    jc, pc, jsde, psde = _sde_pair(name, st=st, reference_st_quirk=quirk)
    assert st_active_for(psde, pc) == jax_st_active_for(jsde, jc)


# ---------------------------------------------------------------------------
# optimizer and EMA
# ---------------------------------------------------------------------------

OPTIMIZERS = {"Adam": dict(optimizer="Adam"),
              "AdamW": dict(optimizer="AdamW", weight_decay=1e-2),
              "AMSGrad": dict(optimizer="Adam", amsgrad=True)}


def _optim_configs(optim):
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  jax_override(jc, {"optim": optim})
  override(pc, {"optim": optim})
  return jc, pc


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("clip", [True, False])
def test_optimizer_trajectory_matches_optax(name, clip):
  """The chain in optax's order: clip, Adam, decay, lr (warmup 3, so the
  first update has lr 0 while the moments move)."""
  optim = dict(OPTIMIZERS[name], lr=2e-4, beta1=0.9, eps=1e-8, warmup=3,
               grad_clip=1.0 if clip else -1.0)
  jc, pc = _optim_configs(optim)
  rng = np.random.RandomState(5)
  p0 = {"a": rng.randn(4, 3).astype(np.float32),
        "b": rng.randn(5).astype(np.float32)}
  # global norms straddle grad_clip = 1.0
  grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
            for k, v in p0.items()} for s in (0.05, 3.0, 0.1, 5.0, 0.2, 2.0)]

  tx = jax_get_optimizer(jc)
  params = jax.tree.map(jnp.asarray, p0)
  opt_state = tx.init(params)
  mine = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in "ab"]
  opt = Optimizer(pc, mine)
  for step, g in enumerate(grads):
    updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   params)
    params = optax.apply_updates(params, updates)
    opt.step([torch.from_numpy(g[k]) for k in "ab"])
    for k, p in zip("ab", mine):
      _close(p.detach(), params[k], rtol=1e-5, atol=1e-7,
             err_msg=f"step {step} {k}")
  assert opt.count == len(grads)


def test_first_update_has_learning_rate_zero():
  _, pc = _optim_configs(dict(lr=1e-2, warmup=4))
  p = torch.nn.Parameter(torch.ones(3))
  opt = Optimizer(pc, [p])
  opt.step([torch.full((3,), 0.5)])
  assert torch.equal(p.detach(), torch.ones(3))  # lr * 0 / 4
  assert (opt.mu[0] != 0).all() and (opt.nu[0] != 0).all()
  opt.step([torch.full((3,), 0.5)])
  assert (p.detach() < 1.0).all()  # lr * 1 / 4


class _Params(torch.nn.Module):

  def __init__(self, tensors, frozen):
    super().__init__()
    for k, v in tensors.items():
      self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    self.frozen = torch.nn.Parameter(torch.from_numpy(frozen),
                                     requires_grad=False)


def test_ema_matches_jax():
  rng = np.random.default_rng(7)
  p = {k: rng.standard_normal(s).astype(np.float32)
       for k, s in (("a", (4, 3)), ("b", (5,)))}
  e = {k: rng.standard_normal(v.shape).astype(np.float32)
       for k, v in p.items()}
  frozen = rng.standard_normal(2).astype(np.float32)
  model = _Params(p, frozen)
  shadow = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
  shadow["frozen"] = torch.from_numpy(frozen.copy())
  want = dict(e)
  for n in (1, 2, 50, 20000):
    want = jax_ema_update(want, p, 0.999, jnp.int32(n))
    ema_update(shadow, model, 0.999, n)
    for k in p:
      _close(shadow[k], want[k], atol=1e-7, err_msg=f"n={n} {k}")
  assert torch.equal(shadow["frozen"], torch.from_numpy(frozen))


# ---------------------------------------------------------------------------
# the training forward: dropout with an injected mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "down"])
def test_block_train_forward_matches_jax_with_the_same_mask(kind,
                                                            monkeypatch):
  """A res-block at train: unfused norm -> SiLU -> dropout(0.1) -> conv,
  FIR down-sampling, both sides given one keep-mask."""
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
  temb = rng.standard_normal((2, 64)).astype(np.float32)
  size = 4 if kind == "down" else 8
  mask = rng.random((2, size, size, 16)) < 0.9
  jblock = jax_layerspp.ResnetBlockBigGANpp(
      act=jax.nn.silu, out_ch=16, down=kind == "down", fir=True,
      dropout=0.1, init_scale=0.1)
  params = jax.jit(lambda k: jblock.init(k, x, temb, False))(
      jax.random.PRNGKey(1))["params"]
  monkeypatch.setattr(jax.random, "bernoulli",
                      lambda key, p, shape: jnp.asarray(mask))
  want = np.asarray(jblock.apply({"params": params}, x, temb, True,
                                 rngs={"dropout": jax.random.PRNGKey(2)}))
  pblock = layerspp.ResnetBlockBigGANpp(
      torch.nn.functional.silu, 16, 16, temb_dim=64, down=kind == "down",
      fir=True, dropout=0.1, init_scale=0.1)
  pblock.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
  monkeypatch.setattr(port_dropout, "keep_mask",
                      lambda shape, keep, gen, device: torch.from_numpy(mask))
  got = pblock(torch.from_numpy(x), torch.from_numpy(temb), train=True)
  assert pblock.last_fused_sites == []
  _close(got.detach(), want, rtol=1e-4, atol=1e-5)


def test_dropout_scales_kept_values_and_is_identity_at_eval():
  gen = torch.Generator().manual_seed(0)
  x = torch.ones(4000)
  drop = port_dropout.Dropout(0.25)
  assert drop(x) is x and port_dropout.Dropout(0.0)(x, True) is x
  y = drop(x, True, gen)
  kept = y != 0
  assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
  assert 0.7 < kept.float().mean() < 0.8
  assert torch.equal(port_dropout.Dropout(1.0)(x, True), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# per-example losses
# ---------------------------------------------------------------------------

WEIGHTINGS = {
    "is": dict(training=dict(importance_sampling=True)),
    "likelihood": dict(training=dict(importance_sampling=False,
                                     likelihood_weighting=True)),
    "default": dict(training=dict(importance_sampling=False,
                                  likelihood_weighting=False)),
    "recon_lossless": dict(training=dict(importance_sampling=False,
                                         likelihood_weighting=True,
                                         reconstruction_loss=True),
                           data=dict(dequantization="lossless")),
    "recon_gauss": dict(training=dict(importance_sampling=False,
                                      likelihood_weighting=False,
                                      reconstruction_loss=True),
                        data=dict(dequantization="uniform")),
}
FAMILIES = [torch_tiny.FLAGSHIP, torch_tiny.UNCSNPP]
LOSS_T_MIN = np.float32(2e-3)


def _batch(pc, seed=0):
  """Data on the 1/255 grid, scaled as the config scales it."""
  k = np.random.default_rng(seed).integers(0, 256, (BATCH, 16, 16, 3))
  x = (k / 255.0).astype(np.float32)
  return 2.0 * x - 1.0 if pc.data.centered else x


def _loss_draws(key, b, shape, recon):
  """What JAX's loss_fn draws from ``key``: t's uniforms, z, recon z."""
  k_t, k_z, k_rz = jax.random.split(key, 3)
  draws = [("uniform", jax.random.uniform(k_t, (b,))),
           ("normal", jax.random.normal(k_z, shape))]
  if recon:
    draws.append(("normal", jax.random.normal(k_rz, shape)))
  return draws


def _replay(draws):
  it = iter(draws)

  def draw(kind, shape):
    want_kind, value = next(it)
    assert (kind, tuple(shape)) == (want_kind, tuple(value.shape))
    return torch.from_numpy(np.array(value))

  draw.left = it
  return draw


@pytest.fixture(scope="module", params=FAMILIES)
def loss_runs(request):
  """Each weighting's JAX losses on one tiny model, in one jitted call."""
  family = request.param
  jc0, pc0, jmodel, params, pmodel = torch_tiny.build(TINY, batch=BATCH,
                                                      family=family)
  cases = {}
  for name, changes in WEIGHTINGS.items():
    jc, pc = torch_tiny.configs(TINY, family)
    jax_override(jc, changes)
    override(pc, changes)
    cases[name] = (jc, pc)
  batch = _batch(pc0)
  key = jax.random.PRNGKey(9)

  def all_losses(p, b):
    out = {}
    for name, (jc, _) in cases.items():
      fn = jax_get_loss_fn(jc, jax_get_sde(jc), train=True)
      out[name] = fn(p, jmodel, b, key, jnp.asarray(LOSS_T_MIN),
                     jc.training.importance_sampling)
    return out

  want = jax.tree.map(np.asarray, jax.jit(all_losses)(params, batch))
  return cases, pmodel, batch, key, want


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
def test_losses_match_jax(loss_runs, weighting):
  cases, pmodel, batch, key, want = loss_runs
  _, pc = cases[weighting]
  IS, recon = (pc.training.importance_sampling,
               pc.training.reconstruction_loss)
  draw = _replay(_loss_draws(key, BATCH, batch.shape, recon))
  fn = get_sde_loss_fn(pc, get_sde(pc), train=True)
  got = fn(pmodel, torch.from_numpy(batch), torch.tensor(LOSS_T_MIN), IS,
           draw)
  assert next(draw.left, None) is None  # every JAX draw consumed
  assert got.shape == (BATCH,) and torch.isfinite(got).all()
  _close(got.detach(), want[weighting],
         rtol=1e-4 if weighting == "recon_lossless" else 1e-5)
