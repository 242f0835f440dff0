"""K train steps per window (soft_truncation_tpu_torch/train/step.py::
make_multi_train_step, run_lib.train's window loop) against the port's own
steps and the JAX package's ``make_multi_train_step`` / ``run_lib._crossed``
on the CPU, where a window runs eagerly (the card's CUDA graph is held to
the eager window by tests/test_torch_multi_step_gpu.py); the window's
route (windows on gloo ranks: tests/test_torch_ddp.py and
tests/test_torch_mesh.py); and the two
leftover public functions, ``sample/ode.py::odeint_rk4_fixed`` and
``utils/profiling.py::annotate``.

Tolerances: a window against the same steps made one by one, bit for bit
(the same operations in the same order); against JAX's window from the
same weights, batches and draws, tests/test_torch_train_step.py's bars
(losses 1e-5 relative, Adam's moments 1e-3 of each tensor's largest, each
parameter's move within 0.05 lr where its gradient is above rounding);
RK4 against JAX's within 1e-5 of max |y| (the linear ODE) and 1e-4 (the
tiny flagship's probability-flow drift, the forward's own agreement).
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.models.score import get_score_fn as jax_get_score_fn
from soft_truncation_tpu.run_lib import _crossed as jax_crossed
from soft_truncation_tpu.sample.ode import odeint_rk4_fixed as jax_rk4
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.sde.core import ReverseSDE as JaxReverseSDE
from soft_truncation_tpu.train import (make_multi_train_step as
                                       jax_make_multi_train_step)
from soft_truncation_tpu.train.state import TrainState as JaxTrainState
from soft_truncation_tpu_torch import main as cli
from soft_truncation_tpu_torch.data import make_preprocess_fn
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.parallel.mesh import Mesh
from soft_truncation_tpu_torch.run_lib import _crossed
from soft_truncation_tpu_torch.sample import odeint_rk4_fixed
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.sde.core import ReverseSDE
from soft_truncation_tpu_torch.train import (init_train_state,
                                             make_multi_train_step,
                                             make_train_step, window_route)
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params
from soft_truncation_tpu_torch.utils.profiling import TRACE_FILE, annotate

import torch_tiny
from test_torch_train import _close, _replay
from test_torch_train_step import _adam_state, _rounding_floor, _step_draws

BATCH = 4
SIZE = torch_tiny.SMALL["data"]["image_size"]
# each case's changes on top of torch_tiny.SMALL: the window's own knobs,
# dropout 0.1 drawn in every step, the dequantization noise drawn in each
# step's preprocess
WINDOW_CASES = {
    "flagship": (torch_tiny.FLAGSHIP, {}),
    "uncsnpp": (torch_tiny.UNCSNPP, {}),
    "flagship-mixed": (torch_tiny.FLAGSHIP,
                       {"training": dict(mixed=True, balanced=True),
                        "optim": dict(num_micro_batch=2)}),
}


def _config(family, changes, width):
  _, pc = torch_tiny.configs(torch_tiny.SMALL, family)
  pc.data.dequantization = "uniform"
  pc.model.dropout = 0.1
  pc.optim.warmup = 2
  pc.training.batch_size = BATCH
  pc.tpu.steps_per_dispatch = width
  for section, values in changes.items():
    pc[section].update(values)
  return pc


def _window(seed, width, batch=BATCH):
  return torch.from_numpy(np.random.default_rng(seed).integers(
      0, 256, (width, batch, SIZE, SIZE, 3), dtype=np.uint8))


def _tensors(state):
  opt = state.optimizer
  return ([state.model.state_dict()[k] for k in state.model.state_dict()]
          + [state.ema[k] for k in state.ema] + opt.mu + opt.nu)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_equals_its_train_steps_bit_for_bit(case):
  """A window of 3 (the generator feeding each step's preprocess, masks
  and draws, the scalars from the state's counts) and its tail of 1
  against 4 preprocess + make_train_step calls: the same bits in the
  losses, parameters, EMA and moments, the same step and count."""
  family, changes = WINDOW_CASES[case]
  config = _config(family, changes, 3)
  sde = get_sde(config)
  states = [init_train_state(config, create_model(config, "cpu", seed=1))
            for _ in range(2)]
  gens = [torch.Generator().manual_seed(5) for _ in range(2)]
  window = make_multi_train_step(config, sde, device="cpu")
  step, preprocess = make_train_step(config, sde), make_preprocess_fn(config)
  for seed, width in ((0, 3), (1, 1)):
    batches = _window(seed, width)
    got = window(states[0], batches, gens[0])
    want = torch.stack([step(states[1], preprocess(b, gens[1]), gens[1])
                        for b in batches])
    assert got.shape == (width, BATCH // (2 if "mixed" in case else 1))
    assert torch.equal(got, want)
  for g, w in zip(_tensors(states[0]), _tensors(states[1])):
    assert torch.equal(g, w)
  assert states[0].step == states[0].optimizer.count == states[1].step == 4
  assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.fixture(scope="module")
def jax_window():
  """JAX's window of 2 steps (jitted once) and the port's, from the same
  weights, uint8 batches and draws (dropout 0, no dequantization: neither
  side draws anything else; two micro-batches, whose keys
  ``_step_draws`` splits as JAX does)."""
  changes = dict(torch_tiny.SMALL, model=dict(torch_tiny.SMALL["model"],
                                              dropout=0.0),
                 optim=dict(warmup=1, lr=1e-3, num_micro_batch=2))
  jc, pc, jmodel, params, pmodel = torch_tiny.build(changes, batch=BATCH)
  pc.tpu.steps_per_dispatch = 2
  jsde, tx = jax_get_sde(jc), jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init(params),
                        ema_params=jax.tree.map(jnp.array, params),
                        ema_rate=float(jc.model.ema_rate))
  window = jax.jit(jax_make_multi_train_step(
      jc, jsde, jmodel, tx, preprocess=jax_datasets.make_preprocess_fn(jc)))
  batches = _window(7, 2).numpy()
  key = jax.random.PRNGKey(11)
  state, _, jax_losses = window(state, batches, key)
  draws = []
  for _ in range(2):  # the window's key chain
    key, _, k_step = jax.random.split(key, 3)
    draws.append(_replay(_step_draws(jc, jsde, k_step,
                                     (BATCH, SIZE, SIZE, 3))))
  pstate = init_train_state(pc, pmodel)
  params0 = {k: v.clone() for k, v in pmodel.state_dict().items()}
  losses = make_multi_train_step(pc, get_sde(pc), device="cpu")(
      pstate, torch.from_numpy(batches), torch.Generator(), draws=draws)
  assert all(next(d.left, None) is None for d in draws)
  adam = _adam_state(state.opt_state)
  names = [n for n, p in pmodel.named_parameters() if p.requires_grad]
  return {"losses": losses.numpy(), "jax_losses": np.asarray(jax_losses),
          "state": pstate, "params0": params0,
          "mu": dict(zip(names, pstate.optimizer.mu)),
          "jax_mu": from_jax_params(
              jax.tree.map(np.asarray, adam.mu)),
          "jax_params": from_jax_params(
              jax.tree.map(np.asarray, state.params)),
          "jax_step": int(state.step)}


def test_window_losses_and_moments_match_jax(jax_window):
  got, want = jax_window["losses"], jax_window["jax_losses"]
  assert got.shape == want.shape == (2, BATCH)
  _close(got, want, rtol=1e-5)
  mu, jax_mu = jax_window["mu"], jax_window["jax_mu"]
  floor = 1e-6 * max(float(np.abs(w.numpy()).max()) for w in jax_mu.values())
  for name, g in mu.items():
    w = jax_mu[name].numpy()
    _close(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), floor),
           err_msg=name)


def test_window_parameters_match_jax(jax_window):
  """Each parameter's move over the window (the first update's learning
  rate 0, the second's lr) against JAX's, where its gradient is above
  rounding."""
  state = jax_window["state"]
  assert state.step == jax_window["jax_step"] == 2
  floors = _rounding_floor(jax_window["jax_mu"])
  sd, moved = state.model.state_dict(), []
  for name, want in jax_window["jax_params"].items():
    start = jax_window["params0"][name].numpy()
    keep = (np.abs(jax_window["jax_mu"][name].numpy()) > floors[name]
            if name in floors else np.ones(start.shape, bool))
    _close((sd[name].numpy() - start)[keep], (want.numpy() - start)[keep],
           rtol=0, atol=0.05 * 1e-3, err_msg=name)
    moved.append(np.abs(want.numpy() - start)[keep])
  assert np.median(np.concatenate(moved)) > 0.5e-3


@pytest.mark.parametrize("width", (1, 2, 3, 4, 7, 8, 16))
def test_crossed_matches_jax_over_the_window_grid(width):
  """The windowed cadence on tests/test_dispatch_window.py's grid: each
  window's label equal to JAX's run_lib._crossed, the same events fired."""
  for freq, init, n, allow_zero in itertools.product(
      (-3, 0, 1, 2, 5, 7, 10), (0, 1, 5, 501), (0, 23, 57), (False, True)):
    step0, n_iters = init, init + n
    fired = []
    while step0 <= n_iters:
      last = min(step0 + width, n_iters + 1) - 1
      got = _crossed(step0, last, freq, allow_zero)
      assert got == jax_crossed(step0, last, freq, allow_zero=allow_zero), (
          step0, last, freq, allow_zero)
      if got is not None:
        fired.append(got)
      step0 = last + 1
    if width == 1:  # every step on the cadence
      assert fired == [s for s in range(init, n_iters + 1)
                       if freq > 0 and s % freq == 0 and (s or allow_zero)]


_CLI_FLAGS = ["--config.data.dataset", "Synthetic",
              "--config.data.image_size", str(SIZE),
              "--config.model.nf", "8", "--config.model.ch_mult", "(1,2)",
              "--config.model.num_res_blocks", "1",
              "--config.model.attn_resolutions", "(4,)",
              "--config.training.batch_size", "4",
              "--config.data.pipeline", "native",
              "--config.tpu.steps_per_dispatch", "3",
              "--config.training.log_freq", "2",
              "--config.training.snapshot_freq", "5",
              "--config.training.snapshot_freq_for_preemption", "3"]


def _run(workdir, n_iters, *flags):
  cli.main(["--config", torch_tiny.PORT_FLAGSHIP, "--workdir", str(workdir),
            "--mode", "train", "--cpu", "--config.training.n_iters",
            str(n_iters), *_CLI_FLAGS, *flags])
  lines = (workdir / "stdout.txt").read_text().splitlines()
  return [int(line.split("step: ")[1].split(",")[0]) for line in lines
          if "training loss mean" in line], lines


def test_cli_windows_tail_and_resume(tmp_path):
  """The CLI trainer on the native pipeline, 3 steps a window: steps
  0..11 in four windows, the log at the step each window crosses, the
  rolling checkpoint at the windows crossing 3, 6 and 9, snapshots at 5
  and 10, the trace of the window holding step 10; then a resume from
  that checkpoint to step 16 (a window of 3 and a tail of 2)."""
  workdir = tmp_path / "w"
  logged, _ = _run(workdir, 11, "--config.tpu.profile_dir",
                   str(tmp_path / "trace"))
  assert logged == [2, 4, 8, 10]
  meta = torch.load(workdir / "checkpoints-meta" / "checkpoint",
                    weights_only=False)
  assert meta["step"] == meta["optimizer"]["count"] == 12
  assert sorted(os.listdir(workdir / "checkpoints")) == [
      "checkpoint_1", "checkpoint_2"]
  with open(tmp_path / "trace" / TRACE_FILE) as f:
    names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
  assert "train window 9-11" in names
  logged, lines = _run(workdir, 16)
  assert any("Starting training loop at step 12." in line for line in lines)
  assert logged[-2:] == [14, 16]
  assert "checkpoint_3" in os.listdir(workdir / "checkpoints")
  last = torch.load(workdir / "checkpoints" / "checkpoint_3",
                    weights_only=False)
  assert last["step"] == 17
  assert all(np.isfinite(v.numpy()).all() for v in last["model"].values())


@pytest.mark.parametrize("device, width, backend, ranks, route", [
    ("cpu", 2, None, 1, "eager"),
    ("cpu", 2, "gloo", 2, "eager"),
    ("cuda", 1, None, 1, "eager"),
    ("cuda", 1, "nccl", 1, "eager"),
    ("cuda", 2, None, 1, "graph"),
    ("cuda", 4, "nccl", 1, "graph"),
    ("cuda", 2, "nccl", 2, "eager"),
    ("cuda", 2, "gloo", 2, "eager"),
])
def test_window_route(device, width, backend, ranks, route):
  """The route of a window of ``width`` steps: a CUDA graph on the card
  alone or as the one rank of an NCCL group; the steps one by one on the
  CPU, at K = 1, on gloo ranks (whose collectives run on the host) and on
  NCCL groups of several ranks (a captured window across cards has not
  yet run)."""
  assert window_route(device, width, backend, ranks) == route


def test_windows_build_under_data_parallelism_and_the_mesh():
  """K = 2 on the CPU under DDP and each mesh shape: route 'eager', fixed
  when the window is made."""
  config = _config(torch_tiny.FLAGSHIP, {}, 2)
  sde = get_sde(config)
  for mesh in (Mesh(data=2), Mesh(data=1, space=2), Mesh(data=2, space=2)):
    window = make_multi_train_step(config, sde, mesh, device="cpu")
    assert (window.width, window.route) == (2, "eager")


def test_rk4_fixed_matches_jax():
  """odeint_rk4_fixed against JAX's: a linear ODE, and the tiny
  flagship's probability-flow drift from t = 1 to 0.5; nfe 4 a step,
  status 0."""
  a = np.random.default_rng(0).standard_normal((6, 6)).astype(np.float32)
  y0 = np.random.default_rng(1).standard_normal(6).astype(np.float32)
  want = jax_rk4(lambda t, y: jnp.asarray(a) @ y * t, jnp.asarray(y0), 0.0,
                 1.3, 7)
  got = odeint_rk4_fixed(lambda t, y: torch.from_numpy(a) @ y * t,
                         torch.from_numpy(y0), 0.0, 1.3, 7)
  assert (got.nfe, got.status) == (int(want.nfe), int(want.status)) == (28,
                                                                        0)
  _close(got.y, want.y, rtol=0, atol=1e-5 * np.abs(np.asarray(want.y)).max())

  jc, pc, jmodel, params, pmodel = torch_tiny.build(torch_tiny.SMALL,
                                                    batch=2)
  jsde, psde = jax_get_sde(jc), get_sde(pc)
  x = np.random.default_rng(2).standard_normal(
      (2, SIZE, SIZE, 3)).astype(np.float32)
  jdrift = JaxReverseSDE(jsde, jax_get_score_fn(jc, jsde, jmodel, params,
                                                continuous=True),
                         probability_flow=True, lambda_=0.0)
  pdrift = ReverseSDE(psde, get_score_fn(pc, psde, pmodel, continuous=True),
                      probability_flow=True, lambda_=0.0)
  want = jax.jit(lambda y: jax_rk4(
      lambda t, v: jdrift.sde(v, jnp.full((2,), t))[0], y, 1.0, 0.5, 2).y)(
          x)
  with torch.no_grad():
    got = odeint_rk4_fixed(
        lambda t, v: pdrift.sde(v, torch.full((2,), t))[0],
        torch.from_numpy(x), 1.0, 0.5, 2)
  assert got.nfe == 8 and got.status == 0
  _close(got.y, want, rtol=0, atol=1e-4 * np.abs(np.asarray(want)).max())


def test_annotate_names_a_region_of_the_trace():
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    with annotate("train window 0-2"):
      torch.ones(8, 8).matmul(torch.ones(8, 8))
  names = [e.key for e in prof.key_averages()]
  assert "train window 0-2" in names and "aten::matmul" in names
