"""The published configs in the port (soft_truncation_tpu_torch/configs/,
models/ncsnpp.py, models/layerspp.py, sde/core.py) against the JAX package,
on the CPU.

- Every one of the JAX package's config files builds in the port at its
  published width, on the meta device: the network, the SDE, the sampler
  and the loss. Each norm -> SiLU -> conv site of one eval forward, and
  each FIR site, is the JAX module's (its abstract trace, one per layout,
  compiles nothing), and each site's choice of the fused kernel or the
  plain chain is JAX's guard with the kernel's plan (``ops/gn_conv.py::
  fits``).
- The layouts the earlier slices did not run, at tiny width, forward
  against JAX from the same weights at the bar of
  tests/test_ncsnpp_parity.py (rtol 2e-3 / atol 2e-4; measured ~1e-5):
  ``lsgm`` (``embedding_dim`` != ``nf``, ``ch_mult`` (1, 1, 1), FIR
  blocks, no pyramid), DDPM blocks with the fixed Fourier features (and
  without auxiliary blocks at one level: JAX's module cannot concatenate
  the skips of more), BigGAN blocks without auxiliary blocks, and the
  pyramids without FIR.
- One train step with the deepest configs' ``lsgm`` embedding and mixed
  loss (importance-sampled half + 100 x the unweighted half, ST with
  k = 0.9), at one level (the FIR blocks' backward is held in
  tests/test_torch_fir_grad.py; a three-level step would triple JAX's
  compile): per-example losses 1e-5 relative, gradients (Adam's first
  moment) 1e-3 of each tensor's largest, as in
  tests/test_torch_train_step.py.
- The subVP SDE: marginals, drift and diffusion, prior, the score's labels
  and the continuous loss, 2e-6 relative (1e-5 for the loss).
"""

import collections
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.losses import get_sde_loss_fn as jax_get_loss_fn
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu.models.score import get_score_fn as jax_score_fn
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.train import make_train_step as jax_make_train_step
from soft_truncation_tpu.train.state import TrainState as JaxTrainState
from soft_truncation_tpu_torch.configs.base import load_config
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.losses import get_sde_loss_fn
from soft_truncation_tpu_torch.models import layerspp
from soft_truncation_tpu_torch.models.registry import get_model
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.ops import gn_conv
from soft_truncation_tpu_torch.sample.sampling import get_sampling_fn
from soft_truncation_tpu_torch.sde import SubVPSDE, get_sde
from soft_truncation_tpu_torch.train import init_train_state, make_train_step
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny
from test_torch_train import _close, _loss_draws, _replay
from test_torch_train_step import _adam_state

JAX_CONFIGS = pathlib.Path(torch_tiny.REPO) / "soft_truncation_tpu" / "configs"
PUBLISHED = sorted(str(p.relative_to(JAX_CONFIGS)) for p in
                   JAX_CONFIGS.rglob("*.py")
                   if p.name not in ("__init__.py", "base.py"))


def _configs(rel):
  module = importlib.import_module(
      "soft_truncation_tpu.configs." + rel[:-3].replace("/", "."))
  return module.get_config(), load_config(
      str(pathlib.Path(torch_tiny.PORT_CONFIGS) / rel))


def _port_sites(pc, size):
  """(H, W, C, O, fused) of each site and (mode, H, W, C) of each FIR site
  of the port's network in one eval forward, walked on the meta device."""
  with torch.device("meta"):
    model = get_model(pc.model.name).from_config(pc).eval()
  sites, firs = [], []
  eligible = layerspp._gn_conv_eligible

  def record(block, h, out_ch, train):
    sites.append(tuple(h.shape[1:]) + (out_ch, eligible(block, h, out_ch,
                                                        train)))
    return False

  def fir_shape_only(module, x, mode, fir_kernel):
    n, h, w, c = x.shape
    firs.append((mode, h, w, c))
    return x.new_empty((n, 2 * h, 2 * w, c) if mode == "up"
                       else (n, h // 2, w // 2, c))

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(layerspp, "_gn_conv_eligible", record)
    mp.setattr(layerspp, "_fir_resample", fir_shape_only)
    with torch.inference_mode():
      model(torch.empty(1, size, size, 3, device="meta"),
            torch.ones(1, device="meta"))
  return model, sites, firs


def _jax_param_shapes(state_dict):
  """The Flax parameter tree's shapes for a port state_dict (the inverse
  of ``from_jax_params``), as ShapeDtypeStructs."""
  tree = {}
  for name, t in state_dict.items():
    *mods, leaf = name.split(".")
    shape = tuple(t.shape)
    if leaf == "weight" and len(shape) == 4:
      leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
    elif leaf == "weight" and len(shape) == 2:
      leaf, shape = "kernel", shape[::-1]
    elif leaf == "weight":
      leaf = "scale"
    node = tree
    for m in mods:
      node = node.setdefault(m, {})
    node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
  return tree


_JAX_SITES = {}
# the model keys that shape the network's sites (not its scales or rates)
_LAYOUT_KEYS = ("nf", "ch_mult", "num_res_blocks", "attn_resolutions",
                "attention", "fir", "fir_kernel", "progressive",
                "progressive_input", "progressive_combine", "resblock_type",
                "embedding_type", "lsgm", "embedding_dim", "conditional",
                "fourier_feature", "auxiliary_resblock", "resamp_with_conv",
                "nonlinearity")


def _jax_sites(jc, state_dict):
  """The JAX module's sites in one eval forward, each with JAX's guard and
  the kernel's plan, and its FIR sites: its abstract trace (no compile),
  once per layout."""
  layout = tuple(repr(jc.model.get(k)) for k in _LAYOUT_KEYS) + (
      jc.data.image_size, jc.data.num_channels)
  if layout not in _JAX_SITES:
    sites, firs = [], []
    guard, up, down = (jax_layerspp._gn_conv_eligible,
                       jax_layerspp.upsample_2d, jax_layerspp.downsample_2d)

    def record(module, h, out_ch, train):
      n, hh, ww, c = h.shape
      fused = (guard(module, h, out_ch, train)
               and gn_conv.fits(n, hh, ww, c, out_ch, min(c // 4, 32)))
      sites.append((hh, ww, c, out_ch, fused))
      return False

    def fir(mode, orig):
      def resample(x, **kw):
        firs.append((mode,) + tuple(x.shape[1:]))
        return orig(x, **kw)
      return resample

    size = jc.data.image_size
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
      mp.setattr(jax_layerspp, "_gn_conv_eligible", record)
      mp.setattr(jax_layerspp, "upsample_2d", fir("up", up))
      mp.setattr(jax_layerspp, "downsample_2d", fir("down", down))
      jmodel = jax_create_model(jc)
      jax.eval_shape(
          lambda p, x, t: jmodel.apply({"params": p}, x, t, train=False),
          _jax_param_shapes(state_dict),
          jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32),
          jax.ShapeDtypeStruct((1,), jnp.float32))
    _JAX_SITES[layout] = sites, firs
  return _JAX_SITES[layout]


@pytest.mark.parametrize("rel", PUBLISHED)
def test_published_config_builds_with_jax_sites(rel):
  jc, pc = _configs(rel)
  size = pc.data.image_size
  model, sites, firs = _port_sites(pc, size)
  want_sites, want_firs = _jax_sites(jc, model.state_dict())
  assert collections.Counter(sites) == collections.Counter(want_sites)
  assert collections.Counter(firs) == collections.Counter(want_firs)
  for h, w, c, o, fused in sites:  # JAX's static bound, restated
    assert not fused or h * w * max(c, o) <= 32 * 32 * 512
  sde = get_sde(pc)
  assert type(sde).__name__ == type(jax_get_sde(jc)).__name__
  shape = (pc.sampling.batch_size, size, size, pc.data.num_channels)
  assert callable(get_sampling_fn(pc, sde, shape,
                                  get_data_inverse_scaler(pc),
                                  pc.sampling.truncation_time))
  assert callable(get_sde_loss_fn(pc, sde, train=True))


def test_published_site_counts():
  """The layouts the card runs, as PERF.md counts them; the deepest
  model's Flax tree (JAX's init, abstractly) and the port's state_dict
  map onto each other leaf for leaf, names and shapes."""
  counts = {}
  for rel in ("vp/CIFAR10/ddpmpp_fid_st_deepest.py",
              "vp/CELEBA/uddpmpp_nll_st.py", "ve/celebahq_256_uncsn.py",
              "ve/ffhq_1024_uncsn.py"):
    jc, pc = _configs(rel)
    model, sites, firs = _port_sites(pc, pc.data.image_size)
    fused = sum(s[-1] for s in sites)
    counts[rel] = (fused, len(sites) - fused, len(firs),
                   sum(p.numel() for p in model.parameters()))
    if "deepest" in rel:
      jmodel = jax_create_model(jc)
      tree = jax.eval_shape(
          lambda k: jmodel.init({"params": k}, jnp.zeros((1, 32, 32, 3)),
                                jnp.ones((1,)), train=False),
          jax.random.PRNGKey(0))["params"]
      assert jax.tree.map(lambda a: (a.shape, a.dtype), tree) == \
          jax.tree.map(lambda a: (a.shape, a.dtype),
                       _jax_param_shapes(model.state_dict()))
  assert counts == {
      "vp/CIFAR10/ddpmpp_fid_st_deepest.py": (101, 9, 8, 373_929_475),
      "vp/CELEBA/uddpmpp_nll_st.py": (76, 6, 0, 61_804_419),
      "ve/celebahq_256_uncsn.py": (52, 34, 36, 65_574_549),
      "ve/ffhq_1024_uncsn.py": (26, 40, 42, 105_785_896)}


# ---------------------------------------------------------------------------
# the new layouts at tiny width, forward against JAX
# ---------------------------------------------------------------------------

LSGM = dict(lsgm=True, embedding_dim=24, ch_mult=(1, 1, 1), fir=True,
            progressive="none", progressive_input="none")
VARIANTS = {
    "lsgm": (torch_tiny.FLAGSHIP, LSGM),
    "ddpm_fourier_feature": (torch_tiny.FLAGSHIP,
                             dict(resblock_type="ddpm",
                                  fourier_feature=True)),
    "ddpm_no_auxiliary_one_level": (torch_tiny.FLAGSHIP,
                                    dict(resblock_type="ddpm",
                                         fourier_feature=True, ch_mult=(1,),
                                         auxiliary_resblock=False)),
    "biggan_no_auxiliary": (torch_tiny.FLAGSHIP,
                            dict(auxiliary_resblock=False)),
    "pyramids_without_fir": (torch_tiny.UNCSNPP,
                             dict(fir=False, progressive_input="input_skip",
                                  progressive_combine="cat")),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax(name):
  family, model = VARIANTS[name]
  changes = dict(torch_tiny.TINY,
                 model=dict(torch_tiny.TINY["model"], **model))
  _, _, jmodel, params, pmodel = torch_tiny.build(changes, family=family)
  rng = np.random.default_rng(0)
  x = rng.standard_normal(torch_tiny.SHAPE).astype(np.float32)
  t = (np.array([10.0, 500.0], np.float32) if family == torch_tiny.FLAGSHIP
       else np.array([0.05, 20.0], np.float32))
  want = torch_tiny.jax_forward(jmodel, params, x, t)
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
  np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
  assert pmodel.fused_sites()  # the kernel's sites at the new blocks
  if name == "lsgm":
    assert pmodel.temb_dense0.weight.shape == (4 * 24, 24)
    assert len(pmodel.fir_sites()) == 8


def test_lsgm_mixed_step_matches_jax():
  """One step of the deepest configs' loss on the lsgm embedding at one
  level: the mixed IS + DDPM halves with ddpm_weight 100, reduce_mean, ST
  with k = 0.9."""
  changes = {"data": dict(torch_tiny.TINY["data"], centered=True),
             "model": dict(torch_tiny.TINY["model"], dropout=0.0,
                           **dict(LSGM, ch_mult=(1,))),
             "training": dict(mixed=True, importance_sampling=False,
                              ddpm_weight=100.0, k=0.9, reduce_mean=True,
                              likelihood_weighting=False, st=True),
             "optim": dict(num_micro_batch=1, warmup=1)}
  jc, pc, jmodel, params, pmodel = torch_tiny.build(changes, batch=2)
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  tx = jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params),
                        ema_params=jax.tree.map(jnp.array, params),
                        ema_rate=float(jc.model.ema_rate))
  batch = (np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3))
           / 127.5 - 1.0).astype(np.float32)
  key = jax.random.PRNGKey(7)
  state, want = jax.jit(jax_make_train_step(jc, jsde, jmodel, tx))(
      state, batch, key)
  pstate = init_train_state(pc, pmodel)
  # one micro-batch: JAX's step hands its loss key to the halves unsplit
  k_tmin, k_loss, _ = jax.random.split(key, 3)
  k_is, k_dd = jax.random.split(k_loss)
  half = (1, 16, 16, 3)
  draw = _replay([("uniform", jax.random.uniform(k_tmin, ()))]
                 + _loss_draws(k_is, 1, half, False)
                 + _loss_draws(k_dd, 1, half, False))
  got = make_train_step(pc, psde)(pstate, torch.from_numpy(batch),
                                  torch.Generator(), draw)
  assert next(draw.left, None) is None
  _close(got, want, rtol=1e-5)
  jax_mu = from_jax_params(jax.tree.map(
      np.asarray, _adam_state(state.opt_state).mu))
  names = [n for n, p in pmodel.named_parameters() if p.requires_grad]
  floor = 1e-6 * max(float(np.abs(v).max()) for v in jax_mu.values())
  for name, mu in zip(names, pstate.optimizer.mu):
    scale = max(float(jax_mu[name].abs().max()), floor)
    assert float((mu - jax_mu[name]).abs().max()) <= 1e-3 * scale, name


# ---------------------------------------------------------------------------
# subVP
# ---------------------------------------------------------------------------


def _subvp_pair():
  jc, pc = torch_tiny.configs(torch_tiny.TINY)
  for c in (jc, pc):
    c.training.sde = "subvpsde"
  return jc, pc, jax_get_sde(jc), get_sde(pc)


def test_subvp_sde_matches_jax():
  jc, pc, jsde, psde = _subvp_pair()
  assert isinstance(psde, SubVPSDE)
  rng = np.random.default_rng(3)
  x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
  t = np.array([1e-5, 0.37, 1.0], np.float32)
  tx, tt = torch.from_numpy(x), torch.from_numpy(t)
  for got, want in ((psde.marginal_prob(tx, tt), jsde.marginal_prob(x, t)),
                    (psde.sde(tx, tt), jsde.sde(x, t)),
                    (psde.discretize(tx, tt), jsde.discretize(x, t))):
    for g, w in zip(got, want):
      _close(g, w, atol=1e-12)
  _close(psde.prior_logp(tx), jsde.prior_logp(x))
  with pytest.raises(NotImplementedError):
    psde.sample_diffusion_time(tt, torch.tensor(1e-5), True)
  for continuous in (True, False):  # subVP's labels are continuous either way
    want = jax_score_fn(jc, jsde, _JaxLinear(), {}, continuous=continuous)(
        x, t)
    got = get_score_fn(pc, psde, _PortLinear(), continuous=continuous)(tx, tt)
    _close(got, want, rtol=1e-5)


class _JaxLinear:
  """A stand-in network: x * 0.5 + labels / 1000."""

  def apply(self, variables, x, labels, train=False, rngs=None):
    return x * 0.5 + labels.reshape(-1, 1, 1, 1) / 1000.0


class _PortLinear(torch.nn.Module):

  def forward(self, x, labels, train=False, generator=None):
    return x * 0.5 + labels.reshape(-1, 1, 1, 1) / 1000.0


def test_subvp_loss_matches_jax():
  jc, pc, jsde, psde = _subvp_pair()
  _, _, jmodel, params, pmodel = torch_tiny.build(torch_tiny.TINY, batch=2)
  batch = (np.random.default_rng(4).integers(0, 256, torch_tiny.SHAPE)
           / 255.0).astype(np.float32)
  key, t_min = jax.random.PRNGKey(11), np.float32(1e-5)
  fn = jax_get_loss_fn(jc, jsde, train=False)
  want = jax.jit(lambda p, b: fn(p, jmodel, b, key, t_min, False))(params,
                                                                   batch)
  draw = _replay(_loss_draws(key, 2, batch.shape, False))
  got = get_sde_loss_fn(pc, psde, train=False)(
      pmodel, torch.from_numpy(batch), torch.tensor(t_min), False, draw)
  assert next(draw.left, None) is None
  _close(got.detach(), want, rtol=1e-5)
