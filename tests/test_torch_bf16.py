"""The port's bf16 compute (``config.tpu.compute_dtype``, ``norm_dtype``,
``ema_dtype``, ``adam_mu_dtype``) against the JAX package's, on the CPU.

Each JAX program is compiled once, in a module-scoped fixture. Tolerances,
each relative to the largest value it is held to, and why:
- (a) the bf16 plain ``gn_silu_conv3x3`` against the JAX kernel in
  interpret mode: bit for bit (both round SiLU to bf16, sum the products of
  bf16 values in f32, add the bias in f32 and round once); the bf16
  tangent plain against ``torch.func.jvp`` of the bf16 chain: 1e-2, one
  bf16 ulp (2^-8) of an output or of a rounded SiLU' * da flipped by the
  f32 order of the closed form against autograd's;
- (b) the bf16 ``fir2`` plain (up, down) and its adjoint against JAX's
  kernel in interpret mode and JAX's VJP of it: 2e-2. The port sums in f32
  and rounds once; JAX computes in bf16, rounding each of the 2 x T
  products and sums per axis, so a result may sit a few bf16 ulps away.
  The same for the replay of the bf16 kernel's TMA route (each band from
  its zero-filled box, ``test_torch_fir._band_replay``), which is held to
  the plain version in f32 at rtol = atol = 1e-5 as well; and the bf16
  launch arguments carry ``band_plan`` field for field;
- (c) the tiny flagship and UNCSN++ with ``compute_dtype='bfloat16'`` (and
  once with ``norm_dtype`` as well), the port's eval forward against JAX's
  from the same weights, JAX's fused sites taking the kernel's arithmetic:
  the same output dtype, 3e-2: every conv rounds its output to bf16 and a
  flipped rounding travels through ~40 layers, each a different sum order
  (XLA's convolutions against oneDNN's);
- (d) ``cast_params_for_eval``'s counterpart: bit for bit;
- (e) the ``Optimizer`` with ``adam_mu_dtype`` against optax's
  ``scale_by_adam(mu_dtype=bfloat16)`` over three steps (the stored ``mu``
  bf16 bit for bit, parameters within 1e-6 of their largest), and the EMA
  step against ``ema_update`` in bf16: bit for bit;
- (f) one likelihood function evaluation (drift, divergence) of the bf16
  tiny flagship against JAX's jvp'd drift: 1e-2 of each part's largest
  (the drift mixes the bf16 score with f32 x; measured 1.8e-3 and 1.1e-4);
- (g) a checkpoint resume with a bf16 EMA and ``mu``: bit for bit;
- (h) a bf16 EMA applied as stored (``load_eval_params``) under a bf16
  compute dtype: each head GroupNorm (``pyr_norm_*``, ``out_norm``) of the
  port on the input JAX's forward gives it, bit for bit Flax's GroupNorm
  of the stored bf16 parameters on that input (bf16 out: the same f32
  statistics and affine, one rounding; within the jitted forward XLA may
  skip a bf16 rounding of the input, ``xla_allow_excess_precision``, so
  the head is held alone); the whole forward at (c)'s 3e-2;
- the bf16 export: its fused operator nodes in bf16, its pre-cast weight
  inputs named in the meta, and the replay bit for bit the eager score.
"""

import functools
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from soft_truncation_tpu.losses.losses import get_optimizer as jax_optimizer
from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu.models.ema import ema_update as jax_ema_update
from soft_truncation_tpu.models.score import get_model_fn as jax_get_model_fn
from soft_truncation_tpu.models.score import get_score_fn as jax_get_score_fn
from soft_truncation_tpu.ops.pallas import fir as jax_fir
from soft_truncation_tpu.ops.pallas import gn_conv as jax_gn_conv
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.sde.core import ReverseSDE as JaxReverseSDE
from soft_truncation_tpu_torch.configs.base import tpu_dtype
from soft_truncation_tpu_torch.likelihood import get_ode_fn
from soft_truncation_tpu_torch.losses import get_optimizer
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.models.ema import ema_init, ema_update
from soft_truncation_tpu_torch.models.score import (cast_params_for_eval,
                                                    get_model_fn,
                                                    load_eval_params)
from soft_truncation_tpu_torch.ops import fir, gn_conv
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.serve import export
from soft_truncation_tpu_torch.run_lib import _eval_model
from soft_truncation_tpu_torch.train import (CheckpointManager,
                                             init_train_state,
                                             make_train_step)

import torch_tiny

BF16 = dict(tpu=dict(compute_dtype="bfloat16"))
BF16_NORM = dict(tpu=dict(compute_dtype="bfloat16", norm_dtype="bfloat16"))
ALL_KNOBS = dict(tpu=dict(compute_dtype="bfloat16", norm_dtype="bfloat16",
                          ema_dtype="bfloat16", adam_mu_dtype="bfloat16"))


def _changes(base, knobs):
  return dict(base, **knobs)


def _rel(got, want):
  got, want = (np.asarray(a, np.float32) for a in (got, want))
  return np.abs(got - want).max() / np.abs(want).max()


def _bf16(a):
  """numpy f32 -> (jax bf16, torch bf16) of the same values."""
  j = jnp.asarray(a).astype(jnp.bfloat16)
  return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


def test_dtype_knobs_take_float32_and_bfloat16_only():
  _, pc = torch_tiny.configs()
  for knob in ("compute_dtype", "norm_dtype", "ema_dtype", "adam_mu_dtype"):
    assert tpu_dtype(pc, knob) == "float32"
    pc.tpu[knob] = "bfloat16"
    assert tpu_dtype(pc, knob) == "bfloat16"
    pc.tpu[knob] = "float16"
    with pytest.raises(ValueError, match="float16"):
      tpu_dtype(pc, knob)
    pc.tpu[knob] = "float32"


def test_kernels_take_bfloat16_and_refuse_float16():
  """The wrappers' bf16 mode on the CPU (the plain versions) keeps bf16;
  float16 raises at the kernel's checks and at the weight operand."""
  x = torch.randn(1, 4, 4, 8)
  w = torch.randn(3, 3, 8, 8)
  # the bf16 kernel's operand: O padded to its 64-wide block, C to its
  # 64-channel chunk
  assert gn_conv.weight_operand(w.bfloat16())[0].shape == (64, 9 * 64)
  with pytest.raises(NotImplementedError, match="float16"):
    gn_conv.weight_operand(w.half())
  with pytest.raises(NotImplementedError, match="float16"):
    gn_conv._kernel_operands("gn", x.half(), (("x", x.half()),), w.half(),
                             2, None, False)
  with pytest.raises(NotImplementedError, match="float16"):
    fir._launch(x.half(), (1.0, 3.0, 3.0, 1.0), 1.0, "up", None, x.device)
  assert fir.fir_upsample2(x.bfloat16(), (1, 3, 3, 1)).dtype == torch.bfloat16
  # the bf16 tile fits wherever the f32 one does: the route is the dtype's
  for shape in ((8, 32, 32, 128, 128), (8, 4, 4, 512, 256)):
    for tangent in (False, True):
      f32, bf16 = (gn_conv.launch_plan(*shape, 32, tangent=tangent, bf16=b)
                   for b in (False, True))
      assert f32.smem <= gn_conv._MAX_SMEM and bf16.smem <= gn_conv._MAX_SMEM


# (a) --------------------------------------------------------------------


def _gn_case(rng, n=2, h=8, w=8, c=16, o=24, groups=4):
  x = (rng.standard_normal((n, h, w, c)) * 2).astype(np.float32)
  gamma = (rng.standard_normal(c) * 0.2 + 1).astype(np.float32)
  beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
  wgt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
  b = rng.standard_normal(o).astype(np.float32)
  return x, gamma, beta, wgt, b, groups


def test_bf16_gn_conv_plain_matches_jax_kernel_bit_for_bit():
  x, gamma, beta, wgt, b, groups = _gn_case(np.random.default_rng(0))
  (jx, tx), (jw, tw), (jb, tb) = _bf16(x), _bf16(wgt), _bf16(b)
  mean, rsqrt = jax_gn_conv.gn_stats(jx, groups)
  with pltpu.force_tpu_interpret_mode():
    want = jax_gn_conv.gn_silu_conv3x3(jx, mean, rsqrt, jnp.asarray(gamma),
                                       jnp.asarray(beta), jw, jb, groups)
  tm, tr = gn_conv.gn_stats(tx, groups)
  np.testing.assert_array_equal(tm.numpy(), np.asarray(mean))
  got = gn_conv.gn_silu_conv3x3(tx, tm, tr, torch.from_numpy(gamma),
                                torch.from_numpy(beta), tw, tb, groups)
  assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
  np.testing.assert_array_equal(got.float().numpy(),
                                np.asarray(want.astype(jnp.float32)))


def test_bf16_gn_conv_tangent_plain_matches_jvp_of_the_bf16_chain():
  x, gamma, beta, wgt, b, groups = _gn_case(np.random.default_rng(1))
  rng = np.random.default_rng(2)
  tx, tdx = (torch.from_numpy(a).bfloat16()
             for a in (x, rng.standard_normal(x.shape).astype(np.float32)))
  g, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
  tw, tb = torch.from_numpy(wgt).bfloat16(), torch.from_numpy(b).bfloat16()
  (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
      lambda v: gn_conv.gn_stats(v, groups), (tx,), (tdx,))
  got = gn_conv.gn_silu_conv3x3_jvp(tx, tdx, mean, dmean, rsqrt, drsqrt, g,
                                    bt, tw, groups)
  _, want = torch.func.jvp(
      lambda v: gn_conv.gn_silu_conv3x3_plain(
          v, *gn_conv.gn_stats(v, groups), g, bt, tw, tb, groups),
      (tx,), (tdx,))
  assert got.dtype == want.dtype == torch.bfloat16
  assert _rel(got.float(), want.float()) <= 1e-2


# (b) --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["up", "down"])
def test_bf16_fir2_and_adjoint_match_jax(mode):
  rng = np.random.default_rng(3)
  k = (1, 3, 3, 1)
  x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
  jx, tx = _bf16(x)
  jax_fn = (jax_fir.fir_upsample2_pallas if mode == "up"
            else jax_fir.fir_downsample2_pallas)
  port_fn = fir.fir_upsample2 if mode == "up" else fir.fir_downsample2
  want = jax_fn(jx, k, interpret=True)
  got = port_fn(tx, k)
  assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
  assert _rel(got.float(), want.astype(jnp.float32)) <= 2e-2
  ybar = rng.standard_normal(want.shape).astype(np.float32)
  jy, ty = _bf16(ybar)
  # JAX's VJP (_fir2_bwd, even T): the other mode, taps reversed, gain 4g
  # (adjoint of up) or g/4 (of down), in interpret mode
  k_rev = tuple(reversed(k))
  want_bar = (jax_fir.fir_downsample2_pallas(jy, k_rev, 4.0, interpret=True)
              if mode == "up" else
              jax_fir.fir_upsample2_pallas(jy, k_rev, 0.25, interpret=True))
  got_bar = fir.fir2_backward(ty, k, 1.0, mode, tuple(x.shape))
  assert got_bar.dtype == torch.bfloat16
  assert _rel(got_bar.float(), want_bar.astype(jnp.float32)) <= 2e-2


@pytest.mark.parametrize("mode", ["up", "down"])
def test_bf16_band_replay_matches_jax_kernel_and_plain(mode):
  """The bf16 kernel's bands, forward and adjoint, at the shapes of the test
  above (its JAX programs, compiled there), against JAX's kernel and VJP in
  interpret mode and the plain version in f32."""
  from test_torch_fir import _band_replay
  rng = np.random.default_rng(3)
  k = (1, 3, 3, 1)
  x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
  jx, tx = _bf16(x)
  jax_fn = (jax_fir.fir_upsample2_pallas if mode == "up"
            else jax_fir.fir_downsample2_pallas)
  want = jax_fn(jx, k, interpret=True)
  got = _band_replay(tx.float().numpy(), k, 1.0, mode)
  assert _rel(got, want.astype(jnp.float32)) <= 2e-2
  np.testing.assert_allclose(
      got, fir._fir2_plain(tx.float(), k, 1.0, mode).numpy(), rtol=1e-5,
      atol=1e-5)
  ybar = rng.standard_normal(want.shape).astype(np.float32)
  jy, ty = _bf16(ybar)
  k_rev = tuple(reversed(k))
  other, gain = ("down", 4.0) if mode == "up" else ("up", 0.25)
  want_bar = (jax_fir.fir_downsample2_pallas(jy, k_rev, 4.0, interpret=True)
              if mode == "up" else
              jax_fir.fir_upsample2_pallas(jy, k_rev, 0.25, interpret=True))
  got_bar = _band_replay(ty.float().numpy(), k_rev, gain, other,
                         tuple(x.shape[1:3]))
  assert _rel(got_bar, want_bar.astype(jnp.float32)) <= 2e-2
  np.testing.assert_allclose(
      got_bar, fir._fir2_plain(ty.float(), k_rev, gain, other,
                               tuple(x.shape[1:3])).numpy(),
      rtol=1e-5, atol=1e-5)


def test_bf16_launch_args_carry_the_band_plan():
  """The bf16 launch arguments (fir2_bf16.cu's Fir2Bf16Args) hold the band
  plan the wrapper's launch takes, and the f32 ones none; the route counts
  start at zero."""
  k = (1.0, 3.0, 3.0, 1.0)
  for mode, shape, out_hw in (("down", (128, 32, 32, 256), (16, 16)),
                              ("up", (3, 5, 7, 72), (11, 15))):
    out_shape, f32, args, plan = fir._launch_args(k, 1.0, mode, shape,
                                                  out_hw, 132)
    assert plan is fir.band_plan(mode, 4, shape, out_hw, 132)
    assert out_shape == (shape[0], *out_hw, shape[3])
    taps = fir._plan(k, 1.0, mode)
    assert (args.T, args.len, args.base) == (4, taps.length, taps.base)
    assert (args.unit_rows, args.unit_cols) == plan.units
    assert (args.images, args.rows, args.cols) == plan.band
    assert (args.box_rows, args.box_cols) == plan.box[1:3]
    assert args.row0 == args.col0 == plan.origin
    assert (args.tiles_n, args.tiles_r, args.tiles_c, args.slabs) == (
        plan.tiles)
    assert args.tiles == math.prod(plan.tiles)
    assert (args.stages, args.stage_bytes, args.smem, args.grid) == (
        plan.stages, plan.stage_bytes, plan.smem, plan.grid)
    assert args.fma_h == fir._exact_products(taps.taps) == 1
    table = list(taps.table)
    assert list(args.table)[:len(table)] == list(f32.table)[:len(table)] == (
        table)
    assert fir._launch_args(k, 1.0, mode, shape, out_hw)[2:] == (None, None)
  fir.reset_launch_counts()
  for wrapper in (fir.fir_upsample2, fir.fir_downsample2):
    for total in ("launches", "backward_launches", "jvp_launches"):
      for route in ("", "tma_", "direct_"):
        assert getattr(wrapper, f"bf16_{route}{total}") == 0
    assert wrapper.bf16_paths == {}


# (c) --------------------------------------------------------------------


def _jax_fused(x, mean, rsqrt, gamma, beta, w, b, groups=32):
  """The JAX kernel's arithmetic in XLA ops (held to the kernel bit for
  bit by (a)): the fold and SiLU in f32, rounded to w's dtype, products
  summed in f32, the bias in f32, one rounding to x's dtype."""
  n, _, _, c = x.shape
  cg = c // groups
  scale = jnp.repeat(rsqrt, cg, axis=1) * gamma[None, :]
  shift = beta[None, :] - jnp.repeat(mean, cg, axis=1) * scale
  a = x.astype(jnp.float32) * scale[:, None, None] + shift[:, None, None]
  a = (a * jax.nn.sigmoid(a)).astype(w.dtype)
  dn = jax.lax.conv_dimension_numbers(a.shape, w.shape,
                                      ("NHWC", "HWIO", "NHWC"))
  out = jax.lax.conv_general_dilated(a, w, (1, 1), "SAME",
                                     dimension_numbers=dn,
                                     preferred_element_type=jnp.float32)
  return (out + b.astype(jnp.float32)).astype(x.dtype)


def _jax_eval_forward(jmodel, params, x, labels):
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
    mp.setattr(jax_gn_conv, "gn_silu_conv3x3", _jax_fused)
    return np.asarray(jax.jit(
        lambda p: jmodel.apply({"params": p}, x, labels, train=False))(
            params).astype(jnp.float32)), jax.eval_shape(
        lambda p: jmodel.apply({"params": p}, x, labels, train=False),
        params).dtype


CASES = {"flagship": (torch_tiny.FLAGSHIP, BF16),
         "uncsnpp": (torch_tiny.UNCSNPP, BF16),
         "uncsnpp_norm_bf16": (torch_tiny.UNCSNPP, BF16_NORM)}


@functools.lru_cache(maxsize=None)
def _small(case):
  """(jc, pc, jmodel, params, pmodel) of a CASES entry, and its inputs."""
  family, knobs = CASES[case]
  built = torch_tiny.build(_changes(torch_tiny.SMALL, knobs), family=family)
  rng = np.random.default_rng(4)
  x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
  labels = (np.array([0.1, 0.8], np.float32) * 999.0
            if family == torch_tiny.FLAGSHIP
            else np.array([0.05, 20.0], np.float32))
  return built, x, labels


@pytest.fixture(scope="module", params=sorted(CASES))
def forward_case(request):
  (_, _, jmodel, params, pmodel), x, labels = _small(request.param)
  want, want_dtype = _jax_eval_forward(jmodel, params, x, labels)
  return pmodel, x, labels, want, want_dtype


def test_bf16_eval_forward_matches_jax(forward_case):
  pmodel, x, labels, want, want_dtype = forward_case
  assert pmodel.dtype == torch.bfloat16
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(labels))
  assert str(got.dtype).split(".")[-1] == str(want_dtype)
  assert len(pmodel.fused_sites()) == 18  # the f32 route's sites
  assert _rel(got.float().numpy(), want) <= 3e-2


# (d) --------------------------------------------------------------------


def test_cast_params_for_eval_changes_no_bit(forward_case):
  pmodel, x, labels, _, _ = forward_case
  cast = cast_params_for_eval(pmodel)
  assert cast and all(t.dtype == torch.bfloat16 for t in cast.values())
  assert not any("norm" in n or "fourier" in n for n in cast)
  with torch.no_grad():
    direct = pmodel(torch.from_numpy(x), torch.from_numpy(labels))
    pre = get_model_fn(pmodel, train=False)(torch.from_numpy(x),
                                            torch.from_numpy(labels))
  assert torch.equal(direct, pre)
  f32 = create_model(torch_tiny.configs()[1], "cpu")
  assert cast_params_for_eval(f32) is None


# (e) --------------------------------------------------------------------


def test_adam_mu_bf16_matches_optax_and_ema_update_matches_jax():
  jc, pc = torch_tiny.configs(dict(ALL_KNOBS, optim=dict(warmup=0)))
  jc.tpu.adam_mu_dtype = "bfloat16"
  rng = np.random.default_rng(5)
  shapes = [(6, 5), (7,)]
  params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
  tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
  opt = get_optimizer(pc, torch.nn.ParameterList(tparams))
  assert all(m.dtype == torch.bfloat16 for m in opt.mu)
  tx = jax_optimizer(jc)
  jparams = [jnp.asarray(p) for p in params]
  state = tx.init(jparams)
  for step in range(3):
    grads = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                               jparams)
    jparams = optax.apply_updates(jparams, updates)
    opt.step([torch.from_numpy(g) for g in grads])
    for got, want in zip(tparams, jparams):
      assert _rel(got.detach().numpy(), want) <= 1e-6, step
  adam = next(s for s in jax.tree.leaves(
      state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
      if isinstance(s, optax.ScaleByAdamState))
  for got, want in zip(opt.mu, adam.mu):
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
  # the EMA step on a bf16 shadow: f32 math, rounded back once
  model = torch.nn.Linear(5, 6)
  ema = ema_init(model, torch.bfloat16)
  assert all(v.dtype == torch.bfloat16 for v in ema.values())
  jema = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
          for k, v in ema.items()}
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.5)
  ema_update(ema, model, 0.999, 7)
  want = jax_ema_update(jema, {k: jnp.asarray(v.detach().numpy())
                               for k, v in model.state_dict().items()},
                        0.999, 7)
  for k, v in ema.items():
    assert v.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(want[k].astype(jnp.float32)))


# (f) --------------------------------------------------------------------


def test_bf16_likelihood_function_evaluation_matches_jax():
  jc, pc, jmodel, params, pmodel = torch_tiny.build(
      _changes(torch_tiny.SMALL, BF16), batch=2)
  shape = (2, 8, 8, 3)
  rng = np.random.default_rng(6)
  x = rng.standard_normal(shape).astype(np.float32)
  eps = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
  t = np.float32(0.5)
  jsde = jax_get_sde(jc)

  def jax_ode(p, x):
    score_fn = jax_get_score_fn(jc, jsde, jmodel, p, train=False,
                                continuous=True)
    rsde = JaxReverseSDE(jsde, score_fn,
                         probability_flow=jc.eval.probability_flow,
                         lambda_=jc.eval.lambda_)
    drift, tangent = jax.jvp(lambda v: rsde.sde(v, jnp.full((2,), t))[0],
                             (x,), (jnp.asarray(eps),))
    return drift, jnp.sum((tangent * eps).reshape(2, -1), axis=-1)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
    mp.setattr(jax_gn_conv, "gn_silu_conv3x3", _jax_fused)
    want_drift, want_div = jax.jit(jax_ode)(params, x)
  ode_fn = get_ode_fn(pc, get_sde(pc), pmodel, torch.from_numpy(eps))
  flat = torch.cat([torch.from_numpy(x).reshape(-1), torch.zeros(2)])
  with torch.no_grad():
    got = ode_fn(t, flat).numpy()
  assert _rel(got[:x.size], np.asarray(want_drift).reshape(-1)) <= 1e-2
  assert _rel(got[x.size:], want_div) <= 1e-2


# (g) --------------------------------------------------------------------


def test_checkpoint_resume_with_bf16_ema_and_mu_is_bit_for_bit(tmp_path):
  _, pc = torch_tiny.configs(_changes(torch_tiny.SMALL, ALL_KNOBS),
                             torch_tiny.UNCSNPP)
  pc.training.batch_size = 2
  sde = get_sde(pc)
  step = make_train_step(pc, sde)
  batch = torch.from_numpy(np.random.default_rng(7).uniform(
      0, 1, (2, 8, 8, 3)).astype(np.float32))

  def fresh():
    return init_train_state(pc, create_model(pc, "cpu", seed=1))

  state = fresh()
  assert all(v.dtype == torch.bfloat16 for v in state.ema.values()
             if v.is_floating_point())
  gen = torch.Generator().manual_seed(0)
  step(state, batch, gen)
  manager = CheckpointManager(str(tmp_path))
  manager.save_meta(state)
  gen_state = gen.get_state()
  losses = step(state, batch, gen)
  assert torch.isfinite(losses).all()
  resumed = manager.restore_meta(fresh())
  assert resumed.optimizer.mu[0].dtype == torch.bfloat16
  gen.set_state(gen_state)
  again = step(resumed, batch, gen)
  assert torch.equal(losses, again)
  for a, b in ((state.ema, resumed.ema),
               (state.model.state_dict(), resumed.model.state_dict())):
    for k in a:
      assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
  for a, b in zip(state.optimizer.mu, resumed.optimizer.mu):
    assert torch.equal(a, b)


# (h) --------------------------------------------------------------------

_HEADS = ("pyr_norm_", "out_norm")


def _jax_heads_and_forward(jmodel, ema, x, labels):
  """JAX's eval forward of the tree ``ema`` as stored (``get_model_fn``,
  its ``cast_params_for_eval``, the fused route in XLA ops), with each head
  GroupNorm's input and output."""
  def run(p):
    heads = {}

    def grab(next_fun, args, kwargs, context):
      out = next_fun(*args, **kwargs)
      module = context.module
      if (isinstance(module, nn.GroupNorm)
          and module.name.startswith(_HEADS)):
        heads[module.name] = (args[0], out)
      return out

    with nn.intercept_methods(grab):
      out = jax_get_model_fn(jmodel, p, train=False)(x, labels)
    return out, heads

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
    mp.setattr(jax_gn_conv, "gn_silu_conv3x3", _jax_fused)
    return jax.jit(run)(ema)


@pytest.mark.parametrize("case", ["flagship", "uncsnpp"])
def test_bf16_ema_applied_as_stored_matches_jax(case):
  """Under ``compute_dtype`` bf16 and a bf16 EMA, the port's evaluation
  model (``run_lib``'s, loaded by ``load_eval_params``) runs its heads'
  GroupNorms on the shadow's bf16 parameters, as JAX applies
  ``state.ema_params``: bf16 in, bf16 out, the same bits."""
  (_, pc, jmodel, params, pmodel), x, labels = _small(case)
  ema = ema_init(pmodel, torch.bfloat16)
  jema = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
  want, heads = _jax_heads_and_forward(jmodel, jema, x, labels)
  assert heads and all(out.dtype == jnp.bfloat16 for _, out in heads.values())
  model = _eval_model(pc, "cpu")
  load_eval_params(model, ema)
  for name, (jin, _) in heads.items():
    norm = model.get_submodule(name)
    assert norm.weight.dtype == norm.bias.dtype == torch.bfloat16, name
    assert jin.dtype == jnp.bfloat16, name
    head = nn.GroupNorm(num_groups=norm.num_groups, epsilon=norm.eps)
    jout = jax.jit(lambda p, v: head.apply({"params": p}, v))(jema[name], jin)
    with torch.no_grad():
      got = norm(torch.tensor(np.asarray(jin.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16, name
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)),
                                  err_msg=name)
  with torch.no_grad():
    got = get_model_fn(model, train=False)(torch.from_numpy(x),
                                           torch.from_numpy(labels))
  assert str(got.dtype).split(".")[-1] == str(want.dtype)
  assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= 3e-2


def test_f32_ema_loads_as_before():
  """An f32 shadow leaves every parameter f32: the load is
  ``load_state_dict``'s, bit for bit."""
  (_, pc, _, _, pmodel), x, labels = _small("uncsnpp")
  ema = ema_init(pmodel, torch.float32)
  model, plain_load = _eval_model(pc, "cpu"), _eval_model(pc, "cpu")
  load_eval_params(model, ema)
  plain_load.load_state_dict(ema)
  assert all(p.dtype == torch.float32 for p in model.parameters())
  with torch.no_grad():
    args = (torch.from_numpy(x), torch.from_numpy(labels))
    assert torch.equal(get_model_fn(model)(*args),
                       get_model_fn(plain_load)(*args))


# the exported sampler -----------------------------------------------------


def test_bf16_export_replays_the_eager_score_bit_for_bit(tmp_path):
  _, pc = torch_tiny.configs(_changes(torch_tiny.SMALL, BF16),
                             torch_tiny.UNCSNPP)
  pmodel = create_model(pc, "cpu", seed=2)
  exported, shape = export.export_sampler(pc, pmodel.state_dict(), 2, "cpu")
  meta = export.artifact_meta(pc, shape, exported)
  assert meta["compute_dtype"] == "bfloat16"
  assert sorted(meta["cast_params"]) == sorted(cast_params_for_eval(pmodel))
  (program,) = exported.programs.values()
  gn_nodes = [n for n in program.graph.nodes if n.op == "call_function"
              and "gn_silu_conv3x3" in str(n.target)]
  assert gn_nodes and all(n.meta["val"].dtype == torch.bfloat16
                          for n in gn_nodes)
  path = str(tmp_path / "p.npz")
  export.save_params_npz(pmodel.state_dict(), path)
  score = export.ExportedScore(exported, meta, export.load_params_npz(path),
                               "cpu")
  rng = np.random.default_rng(8)
  x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
  sigma = torch.tensor([0.05, 20.0])
  with torch.inference_mode():  # as the live service runs it
    want = get_score_fn(pc, get_sde(pc), pmodel, continuous=True)(x, sigma)
    got = score.score_fn(True)(x, sigma)
  assert got.dtype == want.dtype and torch.equal(got, want)
