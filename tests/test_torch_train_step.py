"""The port's train step (soft_truncation_tpu_torch/train/step.py) against
the JAX package's ``make_train_step``, on the CPU: two steps of two
micro-batches each, plain and mixed, from the same weights, data and draws
(handed to the port as tests/test_torch_train.py hands them), dropout at
rate 0; and what the step must leave alone.

Tolerances, beside those of tests/test_torch_train.py:
- losses at each step: 1e-5 relative. The warmup makes the first update's
  learning rate 0 (as optax's schedule at count 0), so the second step
  also starts from equal weights;
- gradients, read as Adam's first and second moments after each step
  (mu = 0.1 g after the first): per tensor, 1e-3 of that tensor's largest
  value. They are sums over the batch and the image, taken in another
  order, with cancellation: a GroupNorm weight's gradient sums ~10^3
  products of both signs to ~1e-2 of their size, so its entries carry
  ~1e-4 relative rounding. A tensor whose true gradient is zero (an
  attention key's bias: softmax ignores a shift of every logit) holds
  rounding only, so the scale is at least 1e-6 of the step's largest
  gradient;
- parameters and EMA: each element's move over the two steps against
  JAX's, absolute 0.05 lr (measured worst 0.015 lr). Adam's step is about
  lr in every element whatever the gradient's size, so where a gradient is
  at rounding level its sign, and the element's step, may flip; elements
  whose moment |mu| is under the gradients' bar above (0.6 % of them) are
  left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.sde.core import st_active_for as jax_st_active_for
from soft_truncation_tpu.train import make_train_step as jax_make_train_step
from soft_truncation_tpu.train.state import TrainState as JaxTrainState
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.train import init_train_state, make_train_step
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny
from test_torch_train import BATCH, TINY, _batch, _close, _loss_draws, _replay

# ---------------------------------------------------------------------------
# the whole step: 2 micro-batches, 2 steps
# ---------------------------------------------------------------------------

# (UNCSN++ mixed is left out: the reciprocal VE SDE ignores the IS flag, so
# its mixed step is two uniformly weighted halves, the path the flagship's
# mixed case runs, and its JAX compile alone would take ~22 s.)
STEP_CASES = {"flagship-plain": (torch_tiny.FLAGSHIP, {}),
              "flagship-mixed-balanced": (torch_tiny.FLAGSHIP,
                                          dict(mixed=True, balanced=True)),
              "uncsnpp-plain": (torch_tiny.UNCSNPP, {})}
STEP_LR = 1e-3


def _step_draws(jc, jsde, key, shape):
  """What JAX's train_step draws from ``key``, in its order."""
  k_tmin, k_loss, _ = jax.random.split(key, 3)
  draws = []
  if jax_st_active_for(jsde, jc):
    draws.append(("uniform", jax.random.uniform(k_tmin, ())))
  num_micro = jc.optim.num_micro_batch
  mb = shape[0] // num_micro
  for mk in jax.random.split(k_loss, num_micro):
    if jc.training.mixed:
      k_is, k_dd = jax.random.split(mk)
      calls = [(k_is, mb // 2), (k_dd, mb - mb // 2)]
    else:
      calls = [(mk, mb)]
    for k, n in calls:
      draws += _loss_draws(k, n, (n,) + tuple(shape[1:]),
                           jc.training.reconstruction_loss)
  return draws


def _adam_state(opt_state):
  return next(s for s in opt_state if hasattr(s, "mu"))


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_run(request):
  """Two train steps of JAX's make_train_step (jitted once) and the
  port's, from the same weights, data and draws."""
  family, training = STEP_CASES[request.param]
  changes = dict(TINY, training=training,
                 optim=dict(num_micro_batch=2, warmup=1, lr=STEP_LR))
  jc, pc, jmodel, params, pmodel = torch_tiny.build(changes, batch=BATCH,
                                                    family=family)
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  tx = jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params),
                        ema_params=jax.tree.map(jnp.array, params),
                        ema_rate=float(jc.model.ema_rate))
  jstep = jax.jit(jax_make_train_step(jc, jsde, jmodel, tx))
  pstate = init_train_state(pc, pmodel)
  pstep = make_train_step(pc, psde)
  out = {"jax_losses": [], "losses": [], "mu": [], "nu": [], "jax_mu": [],
         "jax_nu": []}
  names = [n for n, p in pmodel.named_parameters() if p.requires_grad]
  out["params0"] = {n: v.clone() for n, v in pmodel.state_dict().items()}
  for i in range(2):
    batch = _batch(pc, seed=10 + i)
    key = jax.random.PRNGKey(20 + i)
    state, losses = jstep(state, batch, key)
    out["jax_losses"].append(np.asarray(losses))
    draw = _replay(_step_draws(jc, jsde, key, batch.shape))
    out["losses"].append(pstep(pstate, torch.from_numpy(batch),
                               torch.Generator(), draw).numpy())
    assert next(draw.left, None) is None
    adam = _adam_state(state.opt_state)
    out["jax_mu"].append(from_jax_params(jax.tree.map(np.asarray, adam.mu)))
    out["jax_nu"].append(from_jax_params(jax.tree.map(np.asarray, adam.nu)))
    out["mu"].append(dict(zip(names, [m.clone() for m in
                                      pstate.optimizer.mu])))
    out["nu"].append(dict(zip(names, [v.clone() for v in
                                      pstate.optimizer.nu])))
  out["jax_params"] = from_jax_params(jax.tree.map(np.asarray, state.params))
  out["jax_ema"] = from_jax_params(jax.tree.map(np.asarray,
                                                state.ema_params))
  out["state"], out["jax_step"] = pstate, int(state.step)
  return out


def test_step_losses_match_jax(step_run):
  for step, (got, want) in enumerate(zip(step_run["losses"],
                                         step_run["jax_losses"])):
    assert got.shape == want.shape, step  # [B], or [B/2] when mixed
    _close(got, want, rtol=1e-5, err_msg=f"step {step}")


def test_step_gradients_match_jax(step_run):
  """Adam's moments after each step hold the summed micro-batch gradients
  (clipped): mu = 0.1 g after the first step."""
  for step in range(2):
    for kind in ("mu", "nu"):
      got, want = step_run[kind][step], step_run[f"jax_{kind}"][step]
      assert set(got) <= set(want)
      floor = 1e-6 * max(float(np.abs(w.numpy()).max())
                         for w in want.values())
      for name, g in got.items():
        w = want[name].numpy()
        _close(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), floor),
               err_msg=f"step {step} {kind} {name}")


def _rounding_floor(mu):
  """Per tensor, the |mu| below which the moments are not held to JAX's
  (the bar of test_step_gradients_match_jax)."""
  floor = 1e-6 * max(float(np.abs(m.numpy()).max()) for m in mu.values())
  return {name: 1e-3 * max(float(np.abs(m.numpy()).max()), floor)
          for name, m in mu.items()}


def test_step_params_and_ema_match_jax(step_run):
  """Each parameter's and EMA entry's move from the shared start against
  JAX's. The second step moves an element by ~lr; its EMA by 0.75 of that
  (the warmup decay min(rate, 3/12) at step 2)."""
  state = step_run["state"]
  assert state.step == step_run["jax_step"] == 2
  sd = state.model.state_dict()
  assert set(sd) == set(step_run["jax_params"]) == set(state.ema)
  p0, jax_mu = step_run["params0"], step_run["jax_mu"][-1]
  floors, compared = _rounding_floor(jax_mu), []
  for name, want in step_run["jax_params"].items():
    start = p0[name].numpy()
    keep = (np.abs(jax_mu[name].numpy()) > floors[name] if name in jax_mu
            else np.ones(start.shape, bool))  # frozen: holds still
    want_moved = want.numpy() - start
    _close((sd[name].numpy() - start)[keep], want_moved[keep], rtol=0,
           atol=0.05 * STEP_LR, err_msg=name)
    _close((state.ema[name].numpy() - start)[keep],
           (step_run["jax_ema"][name].numpy() - start)[keep], rtol=0,
           atol=0.05 * STEP_LR, err_msg=f"ema {name}")
    compared.append(np.abs(want_moved[keep]))
  compared = np.concatenate(compared)
  # the bar is well under the moves it holds: a missing, halved or
  # sign-flipped update or EMA would fail it
  assert compared.size > 0.99 * sum(v.numel() for v in p0.values())
  assert np.median(compared) > 0.5 * STEP_LR


# ---------------------------------------------------------------------------
# state hygiene
# ---------------------------------------------------------------------------


def _one_step(family):
  _, pc = torch_tiny.configs(TINY, family)
  pc.optim.warmup = 0
  model = create_model(pc, "cpu", seed=3)
  state = init_train_state(pc, model)
  gen = torch.Generator().manual_seed(0)
  return pc, model, state, make_train_step(pc, get_sde(pc)), gen


def test_fused_weight_cache_follows_the_update():
  """An eval forward after a step uses the stepped weights: the optimizer
  writes on the parameters, which bumps the version DDPMConv.weight_hwio
  caches its transpose by."""
  pc, model, state, step, gen = _one_step(torch_tiny.FLAGSHIP)
  x = torch.from_numpy(_batch(pc))
  t = torch.tensor([5.0, 300.0, 640.5, 999.0])
  with torch.no_grad():
    before = model(x, t)
  assert model.fused_sites()  # the eval forward took the fused path
  step(state, x, gen)
  fresh = create_model(pc, "cpu")
  fresh.load_state_dict(model.state_dict())
  with torch.no_grad():
    got, want = model(x, t), fresh(x, t)
  assert torch.equal(got, want) and not torch.equal(got, before)


def test_fourier_embedding_stays_frozen_and_ema_is_a_copy():
  pc, model, state, step, gen = _one_step(torch_tiny.UNCSNPP)
  w = model.fourier_emb.W
  w0 = w.detach().clone()
  assert not w.requires_grad
  assert all(p is not w for p in state.optimizer.params)
  step(state, torch.from_numpy(_batch(pc)), gen)
  assert torch.equal(w.detach(), w0) and w.grad is None
  assert torch.equal(state.ema["fourier_emb.W"], w0)
  for name, p in model.named_parameters():
    assert state.ema[name].data_ptr() != p.data_ptr(), name
  moved = [n for n, p in model.named_parameters()
           if p.requires_grad and not torch.equal(state.ema[n], p.detach())]
  assert moved  # the step moved the weights; the EMA follows at rate < 1
