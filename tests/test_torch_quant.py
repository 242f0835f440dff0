"""The port's float8 activation storage (soft_truncation_tpu_torch/ops/
quant.py, ``config.tpu.activation_dtype='float8_e4m3'``) against the JAX
package's ``ops/quant.py``, on the CPU.

- The e4m3 / e5m2 rounding helpers bit for bit against ``jnp.astype`` (then
  an upcast) on a grid of the cases where formats part: subnormals, ties,
  447-481 (e4m3's 448 and the NaN past 464), e5m2's 57344-61440 (and inf
  from 61440), +-inf and NaN. A plain ``Tensor.to(torch.float8_e4m3fn)``
  saturates to 448 there and fails the same comparison.
- ``fp8_conv``'s output, dx and dw against JAX's ``fp8_conv`` custom VJP,
  stride 1 and 2, padding SAME and VALID: both round the same inputs the
  same way (e4m3 activation, e5m2 cotangent for dx, the raw cotangent for
  dw), so only the f32 sums differ in order: 1e-5 of each result's
  largest value.
- A tiny UNCSN++ with act_quant against JAX with the same weights: the
  eval forward (the fused sites unquantized, JAX's route with its Pallas
  call taken through the plain reference, at JAX's count) at rtol 1e-4 /
  atol 1e-5 of the output's scale, and the training loss and gradients at
  dropout 0: losses 1e-5 relative, each gradient tensor within 1e-3 of its
  largest value (the bars of tests/test_torch_train*.py). A conv input
  that lands within f32 rounding of an e4m3 rounding boundary could round
  the other way on one side; at these sizes that is rare, and such a flip
  moves one element by an e4m3 step, which these bars would show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.losses import get_sde_loss_fn as jax_get_loss_fn
from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu.ops import quant as jax_quant
from soft_truncation_tpu.ops.pallas import gn_conv as jax_gn_conv
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch.losses import get_sde_loss_fn
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.models.layers import DDPMConv, ddpm_conv
from soft_truncation_tpu_torch.ops import quant
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny
from test_torch_train import _loss_draws, _replay


def _grid():
  e4m3_sub = np.arange(0, 17) * 2.0 ** -10          # ties at odd multiples
  e5m2_sub = np.arange(0, 17) * 2.0 ** -17
  around_448 = np.arange(447.0, 481.5, 0.25)
  edges = [448.0, 463.99, 464.0, 464.01, 479.99, 480.0, 481.0, 1e4, 3e38,
           1e-40, 2.0 ** -126, 2.0 ** -6, 2.0 ** -14]
  e5m2_top = np.concatenate([np.arange(57344.0, 61441.0, 128.0),
                             [61439.99, 61440.01, 65536.0, 1e6]])
  rng = np.random.default_rng(0)
  scaled = rng.standard_normal(2000) * 10.0 ** rng.uniform(-8, 5, 2000)
  finite = np.concatenate([e4m3_sub, e5m2_sub, around_448, edges, e5m2_top,
                           scaled]).astype(np.float32)
  special = np.array([np.inf, -np.inf, np.nan, -np.nan], np.float32)
  return np.concatenate([finite, -finite, [0.0, -0.0], special]).astype(
      np.float32)


def _jax_round(x, dtype):
  return np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_rounding_is_jax_bit_for_bit(fmt):
  x = _grid()
  dtype = jax_quant.E4M3 if fmt == "e4m3" else jax_quant.E5M2
  want = _jax_round(x, dtype)
  fn = quant.round_e4m3 if fmt == "e4m3" else quant.round_e5m2
  got = fn(torch.from_numpy(x)).numpy()
  bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
  assert bad.size == 0, list(zip(x[bad][:8], got[bad][:8], want[bad][:8]))
  if fmt == "e4m3":
    # where torch's saturating cast parts from ml_dtypes (NaN past 464,
    # and for +-inf): a plain cast fails this test
    plain = torch.from_numpy(x).to(torch.float8_e4m3fn).float().numpy()
    parted = np.isnan(want) & ~np.isnan(plain)
    assert parted.sum() > 20 and set(np.abs(plain[parted])) == {448.0}


def _conv_case(stride, padding):
  rng = np.random.default_rng(stride * 10 + len(padding))
  x = (rng.standard_normal((2, 9, 9, 5)) * 3.0).astype(np.float32)
  w = (rng.standard_normal((3, 3, 5, 6)) * 0.2).astype(np.float32)  # HWIO
  pad = padding if isinstance(padding, str) else tuple(padding)
  y, vjp = jax.vjp(lambda a, b: jax_quant.fp8_conv(
      a, b, (stride, stride), pad, jnp.float32), x, w)
  ct = rng.standard_normal(y.shape).astype(np.float32)
  dx, dw = vjp(ct)
  return x, w, ct, [np.asarray(a) for a in (y, dx, dw)]


@pytest.mark.parametrize("stride,padding", [
    (1, "SAME"), (1, "VALID"), (2, "SAME"), (2, "VALID"),
    (2, ((0, 1), (0, 1)))], ids=["1-SAME", "1-VALID", "2-SAME", "2-VALID",
                                 "2-bottom-right"])
def test_fp8_conv_and_its_gradients_match_jax(stride, padding):
  x, w, ct, (y, dx, dw) = _conv_case(stride, padding)
  xt = torch.from_numpy(x).requires_grad_()
  wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
  got = quant.fp8_conv(xt, wt, stride, padding)
  got.backward(torch.from_numpy(ct))
  for name, g, want in (("y", got.detach(), y), ("dx", xt.grad, dx),
                        ("dw", wt.grad.permute(2, 3, 1, 0), dw)):
    g = g.numpy()
    assert g.shape == want.shape, name
    err = np.abs(g - want).max() / np.abs(want).max()
    assert err < 1e-5, (name, err)
  # the e4m3 residual, not x: dw is the raw cotangent against round(x)
  assert not np.allclose(quant.round_e4m3(torch.from_numpy(x)).numpy(), x)


def test_qconv_is_a_drop_in_and_unsupported_dtypes_raise():
  gen = torch.Generator().manual_seed(0)
  plain, q = ddpm_conv(4, 6, 3), ddpm_conv(4, 6, 3, act_quant="float8_e4m3")
  assert isinstance(q, quant.QConv) and type(plain) is DDPMConv
  assert {k: v.shape for k, v in q.state_dict().items()} == {
      k: v.shape for k, v in plain.state_dict().items()}
  plain.reset_parameters(gen)
  q.load_state_dict(plain.state_dict())
  x = torch.randn(2, 5, 5, 4, generator=gen)
  want = plain(quant.round_e4m3(x))
  torch.testing.assert_close(q(x), want, rtol=1e-6, atol=1e-6)
  with pytest.raises(NotImplementedError):
    ddpm_conv(4, 6, 3, act_quant="float8_e5m2")


FP8 = {"data": dict(image_size=8),
       "model": dict(nf=8, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(4,), init_scale=0.1, dropout=0.0),
       "tpu": dict(activation_dtype="float8_e4m3")}
BATCH = 2
LOSS_T_MIN = 1e-3


def _plain_gn_conv(x, mean, rsqrt, gamma, beta, w, b, groups=32):
  """JAX's kernel through its plain reference (the statistics it is handed
  are ``gn_stats`` of the same ``x``, as the reference recomputes them)."""
  return jax_gn_conv.gn_silu_conv3x3_reference(x, gamma, beta, w, b, groups,
                                               eps=1e-6)


@pytest.fixture(scope="module")
def fp8_run():
  """One jitted JAX program: the fp8 UNCSN++'s eval forward on its fused
  route, and its training loss with gradients; and the port's model."""
  jc, pc, jmodel, params, pmodel = torch_tiny.build(
      FP8, batch=BATCH, family=torch_tiny.UNCSNPP)
  rng = np.random.default_rng(3)
  x = rng.standard_normal((BATCH, 8, 8, 3)).astype(np.float32)
  sig = np.array([0.05, 20.0], np.float32)
  batch = rng.uniform(0, 1, (BATCH, 8, 8, 3)).astype(np.float32)
  key = jax.random.PRNGKey(4)
  loss_fn = jax_get_loss_fn(jc, jax_get_sde(jc), train=True)
  sites = []
  fused = jax_layerspp._fused_gn_silu_conv

  def counted(module, h, out_ch, *args, **kwargs):
    sites.append(tuple(h.shape[1:]) + (out_ch,))
    return fused(module, h, out_ch, *args, **kwargs)

  def program(p):
    out = jmodel.apply({"params": p}, x, sig, train=False)

    def mean_loss(q):
      losses = loss_fn(q, jmodel, batch, key, jnp.asarray(LOSS_T_MIN),
                       jc.training.importance_sampling)
      return jnp.mean(losses), losses

    (_, losses), grads = jax.value_and_grad(mean_loss, has_aux=True)(p)
    return out, losses, grads

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
    mp.setattr(jax_layerspp, "_fused_gn_silu_conv", counted)
    mp.setattr(jax_gn_conv, "gn_silu_conv3x3", _plain_gn_conv)
    out, losses, grads = jax.jit(program)(params)
  want = dict(out=np.asarray(out), losses=np.asarray(losses),
              grads=from_jax_params(jax.tree.map(np.asarray, grads)),
              sites=sorted(sites))
  return jc, pc, pmodel, x, sig, batch, key, want


def test_fp8_eval_forward_matches_jax_with_its_fused_sites(fp8_run):
  jc, pc, pmodel, x, sig, _, _, want = fp8_run
  n_quant = sum(isinstance(m, quant.QConv) for m in pmodel.modules())
  assert n_quant > 20
  with torch.no_grad():
    got = pmodel(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
  sites = sorted(pmodel.fused_sites())
  assert sites == want["sites"] and len(sites) == 18
  scale = np.abs(want["out"]).max()
  np.testing.assert_allclose(got, want["out"], rtol=1e-4, atol=1e-5 * scale)
  # quantized where JAX quantizes: the same forward without act_quant
  # (the fused sites unchanged) is another function
  f32 = create_model(torch_tiny.configs(
      dict(FP8, tpu=dict(activation_dtype="")), torch_tiny.UNCSNPP)[1],
      "cpu")
  f32.load_state_dict(pmodel.state_dict())
  with torch.no_grad():
    plain = f32(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
  assert np.abs(plain - got).max() > 1e-4 * scale


def test_fp8_training_loss_and_gradients_match_jax(fp8_run):
  jc, pc, pmodel, _, _, batch, key, want = fp8_run
  pmodel.zero_grad()
  draw = _replay(_loss_draws(key, BATCH, batch.shape,
                             jc.training.reconstruction_loss))
  fn = get_sde_loss_fn(pc, get_sde(pc), train=True)
  losses = fn(pmodel, torch.from_numpy(batch), torch.tensor(LOSS_T_MIN),
              pc.training.importance_sampling, draw, torch.Generator())
  assert next(draw.left, None) is None
  np.testing.assert_allclose(losses.detach().numpy(), want["losses"],
                             rtol=1e-5)
  losses.mean().backward()
  floor = 1e-6 * max(g.abs().max().item() for g in want["grads"].values())
  checked = 0
  for name, p in pmodel.named_parameters():
    if not p.requires_grad:
      continue
    ref = want["grads"][name]
    scale = max(ref.abs().max().item(), floor)
    assert (p.grad - ref).abs().max().item() <= 1e-3 * scale, name
    checked += 1
  assert checked > 50
