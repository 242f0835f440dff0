"""The 2-D ``(data, space)`` mesh of the port (soft_truncation_tpu_torch/
parallel/mesh.py, spatial.py): each rank of a ``space`` group holds H/s
rows of every image, with halo rows, space-wide sums and gathered
attention keys; and the exported sampler replayed on several ranks.

Four gloo processes on the CPU as a ``(2, 2)`` mesh, launched once as
``torchrun`` launches them (``tests/torch_mesh_ranks.py``), run:

- one train step at the JAX package's own 8x8 bar config
  (``tests/test_sharding_invariance.py::_tiny_train_config``, dropout 0:
  the two packages draw other masks) from the same weights, batch and draws
  as JAX's one-device step (compiled once here, the file's one JAX
  program): the per-example losses within rtol 1e-5 / atol 1e-6 and the
  parameters within 1e-5 (JAX's bar; its warmup makes the first update's
  learning rate 0), and Adam's first moment, 0.1 of the gradient, within
  1e-3 of each tensor's largest (tests/test_torch_train_step.py's bar
  against JAX);
- the same step at 64x64 with attention at 32x32, and a 256x256 UNCSN++
  step (FIR, residual input pyramid, reciprocal VE: ``:120-140`` of that
  file), with dropout 0.1 and Adam moving every parameter (warmup 0; eps
  1e-3 as tests/test_torch_ddp.py takes it), against the port's one
  process on the same batch and generator (earlier tests hold that to
  JAX): losses to the same bar, parameters and EMA within 1e-5, Adam's
  moments within 1e-5 of their largest;
- a window of 2 steps (``make_multi_train_step`` on the mesh, route
  'eager' on gloo ranks) at the 8px config from the same weights, on
  uint8 batches with JAX's draws: bit for bit the same 2 steps as
  ``make_train_step`` calls on each rank, and against JAX's
  ``make_multi_train_step`` on one device (compiled in a second thread)
  to the 8px step's bars;
- the CLI trainer with ``--config.tpu.mesh_shape "(2, 2)"`` against one
  process's CLI run: the checkpoint, the log, each rank's logged shard;
  and at ``tpu.steps_per_dispatch`` 2, steps 0..1 as one window, against
  one process a step at a time;
- the tiny flagship exported with ``mesh=(4,)`` at batch 8 and replayed on
  the four ranks (``SamplingService.from_artifact``, rank 0 taking the
  requests) against the one-process artifact at batch 8: ``dpm_solver``,
  ``ode`` and ``pc`` (3 steps, a Langevin corrector) uint8 samples equal,
  every rank's nfe equal to one process's.

Then unit cases without processes: the halo / crop index math of each
sharded layer against a slice of the whole image's result, the mesh
checks, the sharded draws, and the refusals under a space axis.
"""

import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu.losses import get_optimizer as jax_get_optimizer
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.train import (make_multi_train_step as
                                       jax_make_multi_train_step)
from soft_truncation_tpu.train import make_train_step as jax_make_train_step
from soft_truncation_tpu.train.state import TrainState as JaxTrainState
from soft_truncation_tpu_torch import main as cli
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.models.dropout import batch_shard, keep_mask
from soft_truncation_tpu_torch.models.layers import DDPMConv, GroupNorm, attend
from soft_truncation_tpu_torch.ops import resample
from soft_truncation_tpu_torch.parallel import ddp, mesh as mesh_lib, spatial
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.serve import export
from soft_truncation_tpu_torch.serve.server import SamplingService
from soft_truncation_tpu_torch.train import init_train_state, make_train_step
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny
from test_sharding_invariance import _tiny_train_config
from test_torch_ddp import FLAGS as DDP_FLAGS
from test_torch_ddp import _free_port
from test_torch_train_step import _adam_state, _step_draws

MESH = (2, 2)
RANKS = 4
WINDOW = 2  # tpu.steps_per_dispatch of the window case and CLI run
WORKER = os.path.join(torch_tiny.REPO, "tests", "torch_mesh_ranks.py")

# the JAX bar config's knobs, as the port's overrides
_TINY = {
    "training": dict(sde="vpsde", continuous=True, reduce_mean=True, st=True,
                     k=1.0, likelihood_weighting=False,
                     truncation_time=1e-5, batch_size=16),
    "optim": dict(num_micro_batch=2, warmup=10),
    "data": dict(image_size=8, centered=True),
    "model": dict(
        name="ncsnpp", scale_by_sigma=False, ema_rate=0.999,
        normalization="GroupNorm", nonlinearity="swish", nf=8,
        ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
        resamp_with_conv=True, conditional=True, fir=False,
        fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type="biggan",
        progressive="none", progressive_input="none",
        progressive_combine="sum", init_scale=0.0, embedding_type="fourier",
        fourier_scale=16),
}
# each case's changes on top of it (tests/test_sharding_invariance.py)
STEPS = {
    "8px": {"model": dict(dropout=0.0)},
    "64px": {"training": dict(batch_size=8), "data": dict(image_size=64),
             "model": dict(attn_resolutions=(32,), init_scale=0.1),
             "optim": dict(warmup=0, eps=1e-3)},
    "256px": {"training": dict(sde="reciprocal_vesde", st=True, batch_size=4,
                               model_mode="reciprocal", eta=0.001,
                               importance_sampling=False,
                               likelihood_weighting=False),
              "optim": dict(num_micro_batch=1, warmup=0, eps=1e-3),
              "data": dict(image_size=256, centered=False),
              # the Bernoulli masks this case was written with: under the
              # default 8-bit masks one of out_conv.weight's Adam second
              # moments lands at 1.047 of the 1e-5 bar, against 0.56 with
              # these; 64px runs the 8-bit masks on the mesh. Measured by
              # tests/torch_mesh_spread.py at 8 bits: the mesh's kept lanes
              # are one process's (0 of 13,107,200 differ over its 20
              # dropouts), and one process's own step with its samples in
              # another order puts that moment at 1.61 of the bar (mu 0.81):
              # rounding alone passes 1e-5 here, so the case keeps 32 bits
              "tpu": dict(dropout_bits=32),
              "model": dict(scale_by_sigma=True, fir=True,
                            fir_kernel=[1, 3, 3, 1], ch_mult=(1, 1, 2, 2),
                            num_res_blocks=1, attn_resolutions=(32,),
                            progressive_input="residual", sigma_min=0.001,
                            init_scale=0.1)},
}
REQUESTS = [(8, 3, "dpm_solver"), (8, 4, "ode"), (8, 5, "pc")]


def _port_config(name):
  config = default_config("cifar10")
  override(config, _TINY)
  override(config, STEPS[name])
  return config


def _batch(config, seed):
  """Uniform images in the data's range."""
  size = config.data.image_size
  u = np.random.default_rng(seed).uniform(
      0.0, 1.0, (config.training.batch_size, size, size, 3)).astype(
          np.float32)
  return 2.0 * u - 1.0 if config.data.centered else u


def _jax_case():
  """JAX's bar config (dropout 0), the port's weights set into its tree,
  the batch and the draws of JAX's step; JAX's one-device step is run
  later (:func:`_jax_step`)."""
  jc = _tiny_train_config()
  jc.model.dropout = 0.0
  pc = _port_config("8px")
  jmodel = jax_create_model(jc)
  size = jc.data.image_size
  template = jax.eval_shape(
      lambda k: jmodel.init({"params": k}, jnp.zeros((1, size, size, 3)),
                            jnp.full((1,), 0.5), train=False),
      jax.random.PRNGKey(0))["params"]
  params = create_model(pc, "cpu", seed=0).state_dict()
  jparams = torch_tiny.to_jax_params(params, template)
  batch = _batch(pc, 1)
  key = jax.random.PRNGKey(2)
  draws = [(k, np.asarray(v)) for k, v in
           _step_draws(jc, jax_get_sde(jc), key, batch.shape)]
  return jc, jmodel, jparams, key, dict(config=pc, params=params,
                                        batch=batch, seed=0, draws=draws)


def _window_case(jc, params):
  """A window of WINDOW steps at the 8px case's config, weights and bar,
  on uint8 batches (no dequantization: neither side draws anything but
  the steps' draws), each step's draws JAX's for its key in the window's
  chain (``key, _, k_step = split(key, 3)``)."""
  config = _port_config("8px")
  config.tpu.steps_per_dispatch = WINDOW
  size = config.data.image_size
  batches = np.random.default_rng(3).integers(
      0, 256, (WINDOW, config.training.batch_size, size, size, 3),
      dtype=np.uint8)
  key = chain = jax.random.PRNGKey(4)
  draws = []
  for _ in range(WINDOW):
    chain, _, k_step = jax.random.split(chain, 3)
    draws.append([(k, np.asarray(v)) for k, v in _step_draws(
        jc, jax_get_sde(jc), k_step, batches.shape[1:])])
  return key, dict(config=config, params=params, batches=batches, seed=0,
                   draws=draws)


def _jax_window(jc, jmodel, jparams, key, batches):
  """JAX's ``make_multi_train_step`` (a scan of the steps, each step's
  preprocess inside it) on one device."""
  sde, tx = jax_get_sde(jc), jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                        opt_state=tx.init(jparams),
                        ema_params=jax.tree.map(jnp.array, jparams),
                        ema_rate=float(jc.model.ema_rate))
  state, _, losses = jax.jit(jax_make_multi_train_step(
      jc, sde, jmodel, tx, preprocess=jax_datasets.make_preprocess_fn(jc)))(
          state, batches, key)
  return {"losses": np.asarray(losses), "step": int(state.step),
          "params": from_jax_params(jax.tree.map(np.asarray, state.params)),
          "mu": from_jax_params(jax.tree.map(
              np.asarray, _adam_state(state.opt_state).mu))}


def _jax_step(jc, jmodel, jparams, key, batch):
  sde, tx = jax_get_sde(jc), jax_get_optimizer(jc)
  state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                        opt_state=tx.init(jparams),
                        ema_params=jax.tree.map(jnp.array, jparams),
                        ema_rate=float(jc.model.ema_rate))
  state, losses = jax.jit(jax_make_train_step(jc, sde, jmodel, tx))(
      state, batch, key)
  return {"losses": np.asarray(losses),
          "params": from_jax_params(jax.tree.map(np.asarray, state.params)),
          "mu": from_jax_params(jax.tree.map(
              np.asarray, _adam_state(state.opt_state).mu))}


def _port_step(case):
  """The port's one-process step of a case."""
  config = case["config"]
  model = create_model(config, "cpu")
  model.load_state_dict(case["params"])
  state = init_train_state(config, model)
  losses = make_train_step(config, get_sde(config))(
      state, torch.from_numpy(case["batch"]),
      torch.Generator().manual_seed(case["seed"]))
  return losses, state.state_dict()


def _cli_argv(workdir, mesh=None, n_iters=0, window=1):
  argv = ["--config", torch_tiny.PORT_FLAGSHIP, "--workdir", str(workdir),
          "--mode", "train", "--cpu", "--config.training.n_iters",
          str(n_iters), "--config.tpu.steps_per_dispatch", str(window)]
  argv += DDP_FLAGS
  if mesh:
    argv += ["--config.tpu.mesh_shape", str(mesh)]
  return argv


def _replay_config():
  # init_scale 0.03: signal in every conv, ~220 ode evaluations
  _, config = torch_tiny.configs(dict(torch_tiny.SMALL, model=dict(
      torch_tiny.SMALL["model"], init_scale=0.03)))
  config.sampling.dpm_steps = 5
  # beta_max 1 (of 20): with random weights at 20 over 99 % of the uint8
  # samples clip to 0 or 255 (pc's are NaN), at 1 about half of them
  config.model.beta_max = 1.0
  # pc: 3 steps, each a Langevin corrector step (its step size a mean over
  # the whole batch) and an Euler-Maruyama step, both drawing noise
  config.model.num_scales = 3
  config.sampling.corrector = "langevin"
  return config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """The four ranks' results, and what each is held to."""
  tmp = tmp_path_factory.mktemp("mesh")
  jc, jmodel, jparams, key, jax_case = _jax_case()
  # JAX compiles its step in a thread (XLA's compile drops the GIL) while
  # the ranks and this process run the port
  window_key, window_case = _window_case(jc, jax_case["params"])
  jax_thread = concurrent.futures.ThreadPoolExecutor(2)
  jax_step = jax_thread.submit(_jax_step, jc, jmodel, jparams, key,
                               jax_case["batch"])
  jax_window = jax_thread.submit(_jax_window, jc, jmodel, jparams,
                                 window_key, window_case["batches"])
  steps = {"8px": jax_case}
  for seed, name in enumerate(("64px", "256px")):
    config = _port_config(name)
    steps[name] = dict(config=config, batch=_batch(config, 10 + seed),
                       seed=20 + seed,
                       params=create_model(config, "cpu", seed=seed
                                           ).state_dict())
  replay_config = _replay_config()
  params = create_model(replay_config, "cpu", seed=3).state_dict()
  npz = str(tmp / "params.npz")
  export.save_params_npz(params, npz)
  mesh_artifact, one_artifact = str(tmp / "mesh.pt2"), str(tmp / "one.pt2")
  spec = {"mesh_shape": MESH, "steps": steps,
          "windows": {"8px": window_case},
          "cli": [_cli_argv(tmp / "cli_ranks", MESH),
                  _cli_argv(tmp / "cli_windows", MESH, WINDOW - 1, WINDOW)],
          "replays": {"flagship": dict(
              config=replay_config, weights=params, batch=8,
              artifact=mesh_artifact, params=npz, requests=REQUESTS)}}
  torch.save(spec, tmp / "spec.pt")
  env = dict(os.environ, WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS),
             MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
             OMP_NUM_THREADS="1",
             PYTHONPATH=torch_tiny.REPO + os.pathsep
             + os.environ.get("PYTHONPATH", ""))
  procs = [subprocess.Popen(
      [sys.executable, WORKER, str(tmp / "spec.pt"), str(tmp)],
      env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=torch_tiny.REPO,
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(RANKS)]
  try:
    # meanwhile, what the ranks are held to
    exported, shape = export.export_sampler(replay_config, params, 8, "cpu")
    export.save_artifact(exported, export.artifact_meta(
        replay_config, shape, exported), one_artifact)
    service = SamplingService.from_artifact(one_artifact, npz, "cpu")
    want = {"replays": [service.sample(*r) for r in REQUESTS]}
    cli.main(_cli_argv(tmp / "cli_alone"))
    cli.main(_cli_argv(tmp / "cli_steps", n_iters=WINDOW - 1))
    want["steps"] = {name: _port_step(steps[name])
                     for name in ("64px", "256px")}
    want["jax"] = jax_step.result()
    want["jax_window"] = jax_window.result()
    outs = [p.communicate(timeout=600)[0] for p in procs]
  finally:
    jax_thread.shutdown()
    for p in procs:
      p.kill()
  for r, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
  got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
         for r in range(RANKS)]
  return {"got": got, "want": want, "steps": steps, "outs": outs,
          "tmp": tmp, "window": window_case}


def _data_rows(losses, config, data_index):
  """The rows of the one-process losses a data group holds (of each
  micro-batch its slice)."""
  parts = config.optim.num_micro_batch
  return losses.reshape(parts, MESH[0], -1)[:, data_index].reshape(-1)


def _close(got, want, rtol=1e-5, atol=1e-6, **kw):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol, **kw)


def test_ranks_sit_on_the_mesh_and_hold_their_rows(runs):
  """Each rank holds its shard and ran the same collectives as the others:
  a halo, sum and gather each way (the input image's halo takes no
  backward)."""
  first = runs["got"][0]["steps"]
  for r, got in enumerate(runs["got"]):
    assert got["mesh"] == divmod(r, MESH[1])
    for name, case in runs["steps"].items():
      b, size = case["config"].training.batch_size, case["config"].data.image_size
      step = got["steps"][name]
      assert step["local_shape"] == (b // MESH[0], size // MESH[1], size,
                                     3), name
      calls = step["collectives"]
      assert calls == first[name]["collectives"], (r, name)
      assert 0 < calls["halo_backward"] < calls["halo"], (name, calls)
      assert calls["sum"] == calls["sum_backward"] > 0, (name, calls)
      assert calls["gather"] == calls["gather_backward"] > 0, (name, calls)


def test_8px_step_matches_jax_one_device(runs):
  """JAX's own bar (tests/test_sharding_invariance.py:78-85), with the
  gradients held too."""
  want, config = runs["want"]["jax"], runs["steps"]["8px"]["config"]
  for r, got in enumerate(runs["got"]):
    step = got["steps"]["8px"]
    _close(step["losses"], _data_rows(want["losses"], config, r // MESH[1]),
           err_msg=f"rank {r}")
    model = step["state"]["model"]
    assert max(float(np.abs(model[k].numpy() - v.numpy()).max())
               for k, v in want["params"].items()) < 1e-5
    names = [n for n, p in create_model(config, "cpu").named_parameters()
             if p.requires_grad]
    mu = dict(zip(names, step["state"]["optimizer"]["mu"]))
    assert len(mu) > 30
    for name, g in mu.items():
      w = want["mu"][name].numpy()
      _close(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-12),
             err_msg=f"rank {r} mu {name}")


def test_window_on_the_mesh_is_its_steps_bit_for_bit(runs):
  """A window of 2 on the (2, 2) mesh (route 'eager' on gloo ranks)
  against the same 2 steps as make_train_step calls on the same rank:
  the same bits in the losses and the state, the same collectives, each
  step's those of the 8px step case (the same config and shapes)."""
  for r, got in enumerate(runs["got"]):
    window = got["windows"]["8px"]
    assert window["route"] == "eager"
    assert torch.equal(window["losses"], window["step_losses"]), r
    state, want = window["state"], window["step_state"]
    assert state["step"] == want["step"] == WINDOW
    for part in ("model", "ema"):
      for k, w in want[part].items():
        assert torch.equal(state[part][k], w), (r, part, k)
    for k in ("mu", "nu"):
      for g, w in zip(state["optimizer"][k], want["optimizer"][k]):
        assert torch.equal(g, w), (r, k)
    per_step = got["steps"]["8px"]["collectives"]
    assert window["collectives"] == window["step_collectives"] == {
        k: WINDOW * n for k, n in per_step.items()}, r
    assert per_step["gradients"] == 1


def test_window_on_the_mesh_matches_jax_one_device(runs):
  """The window against JAX's make_multi_train_step on one device, to
  test_8px_step_matches_jax_one_device's bars."""
  want, config = runs["want"]["jax_window"], runs["window"]["config"]
  assert want["step"] == WINDOW
  for r, got in enumerate(runs["got"]):
    window = got["windows"]["8px"]
    assert window["losses"].shape == (WINDOW, config.training.batch_size
                                      // MESH[0])
    for k in range(WINDOW):
      _close(window["losses"][k], _data_rows(want["losses"][k], config,
                                             r // MESH[1]),
             err_msg=f"rank {r} step {k}")
    model = window["state"]["model"]
    assert max(float(np.abs(model[k].numpy() - v.numpy()).max())
               for k, v in want["params"].items()) < 1e-5
    names = [n for n, p in create_model(config, "cpu").named_parameters()
             if p.requires_grad]
    mu = dict(zip(names, window["state"]["optimizer"]["mu"]))
    assert len(mu) > 30
    for name, g in mu.items():
      w = want["mu"][name].numpy()
      _close(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-12),
             err_msg=f"rank {r} mu {name}")


@pytest.mark.parametrize("name", ["64px", "256px"])
def test_step_matches_one_process(runs, name):
  losses, state = runs["want"]["steps"][name]
  config = runs["steps"][name]["config"]
  for r, got in enumerate(runs["got"]):
    step = got["steps"][name]
    _close(step["losses"], _data_rows(losses.numpy(), config, r // MESH[1]),
           err_msg=f"rank {r}")
    _assert_same_state(step["state"], state, atol=1e-5)


def _assert_same_state(got, want, atol, steps=1):
  assert got["step"] == want["step"] == steps
  moved = 0
  for part in ("model", "ema"):
    for k, w in want[part].items():
      torch.testing.assert_close(got[part][k], w, rtol=0, atol=atol,
                                 msg=f"{part} {k}")
  for k in ("mu", "nu"):
    largest = max(w.abs().max().item() for w in want["optimizer"][k])
    for g, w in zip(got["optimizer"][k], want["optimizer"][k]):
      torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * largest)
      moved += int(w.abs().max() > 0)
  assert moved > 40


def test_cli_trainer_on_the_mesh_trains_as_one_process(runs):
  tmp = runs["tmp"]
  got, want = (torch.load(tmp / d / "checkpoints" / "checkpoint_0",
                          map_location="cpu", weights_only=True)
               for d in ("cli_ranks", "cli_alone"))
  _assert_same_state(got, want, atol=1e-6)
  for r, out in enumerate(runs["outs"]):  # every rank logs its shard
    data, space = divmod(r, MESH[1])
    assert (f"mesh (data 2, space 2): rank {r} at ({data}, {space}), local "
            "batch [4, 8, 16, 3]") in out
  logs = [(tmp / d / "stdout.txt").read_text() for d in ("cli_ranks",
                                                         "cli_alone")]
  means = [[line.split("training loss mean: ")[1].split(",")[0]
            for line in log.splitlines() if "training loss mean" in line]
           for log in logs]
  assert len(means[0]) == 1 and means[0] == means[1]


def test_cli_trainer_on_the_mesh_trains_windows_as_one_process(runs):
  """The CLI trainer on the mesh at ``tpu.steps_per_dispatch`` 2, steps
  0..1 in one eager window, against one process a step at a time: the
  same checkpoint, the log at the window's last step."""
  tmp = runs["tmp"]
  got, want = (torch.load(tmp / d / "checkpoints" / "checkpoint_0",
                          map_location="cpu", weights_only=True)
               for d in ("cli_windows", "cli_steps"))
  _assert_same_state(got, want, atol=1e-6, steps=WINDOW)
  for out in runs["outs"]:
    assert (f"train windows of {WINDOW} steps: route eager (process group "
            "gloo)") in out
  logged = [[int(line.split("step: ")[1].split(",")[0])
             for line in (tmp / d / "stdout.txt").read_text().splitlines()
             if "training loss mean" in line]
            for d in ("cli_windows", "cli_steps")]
  assert logged == [[WINDOW - 1], list(range(WINDOW))]


def test_sharded_replay_is_one_process(runs):
  """dpm_solver's, ode's and pc's uint8 samples equal one process's (pc's
  noise cut from the whole batch's, its Langevin step size the whole
  batch's); every rank took ode's steps (its error norms all-reduced)."""
  want = runs["want"]["replays"]
  got0 = runs["got"][0]["replays"]["flagship"]
  for (samples, nfe), (want_samples, want_nfe), req in zip(got0, want,
                                                           REQUESTS):
    assert samples.shape == want_samples.shape == (8, 8, 8, 3)
    np.testing.assert_array_equal(samples, want_samples, err_msg=req[2])
    assert nfe == want_nfe, req
  assert want[1][1] > 20  # ode took adaptive steps
  for r in range(1, RANKS):
    assert runs["got"][r]["replays"]["flagship"] == [n for _, n in want]


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------


class _Slices(spatial.Space):
  """Rank ``index`` of ``size`` whose halo comes from the whole input
  ``full`` (zeros past its edges): a layer's index math without a
  group."""

  def __init__(self, full, index, size):
    super().__init__(None, index, size)
    self.full = full

  def _halo(self, x, above, below):
    n = x.shape[1]
    padded = torch.nn.functional.pad(self.full, (0, 0, 0, 0, above, below))
    return padded[:, self.index * n:self.index * n + n + above + below]


def _sharded(fn, full, size):
  """``fn`` of each rank's rows, concatenated."""
  outs = []
  for i in range(size):
    space = _Slices(full, i, size)
    with spatial.sharded(space):
      outs.append(fn(space.rows(full)))
  return torch.cat(outs, 1)


_K = (1, 3, 3, 1)
_W = torch.randn(3, 3, 4, 5, generator=torch.Generator().manual_seed(1))
_LAYERS = {
    "conv3x3": DDPMConv(4, 5, 3),
    "conv3x3_stride2": DDPMConv(4, 5, 3, stride=2),
    "conv1x1": DDPMConv(4, 5, 1),
    "fir2_up": lambda x: resample.upsample_2d(x, _K),
    "fir2_down": lambda x: resample.downsample_2d(x, _K),
    "fir2_up_6taps": lambda x: resample.upsample_2d(x, (1, 2, 5, 5, 2, 1)),
    "fir2_down_6taps": lambda x: resample.downsample_2d(x, (1, 2, 5, 5, 2, 1)),
    "upfirdn2d_up": lambda x: resample.upfirdn2d(
        x, resample.setup_fir_kernel(_K, 4.0), up=2, pad=(2, 1)),
    "upfirdn2d_down": lambda x: resample.upfirdn2d(
        x, resample.setup_fir_kernel(_K), down=2, pad=(1, 1)),
    "upsample_conv_2d": lambda x: resample.upsample_conv_2d(x, _W, _K),
    "conv_downsample_2d": lambda x: resample.conv_downsample_2d(x, _W, _K),
}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("layer", sorted(_LAYERS))
def test_halo_and_crop_match_a_slice_of_the_whole(layer, size):
  x = torch.randn(2, 16, 12, 4, generator=torch.Generator().manual_seed(0))
  fn = _LAYERS[layer]
  want = fn(x)
  got = _sharded(fn, x, size)
  assert got.shape == want.shape
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_a_halo_wider_than_the_shard_raises():
  x = torch.zeros(1, 8, 8, 4)  # 2 rows a shard; 8 taps reach 4 above
  with pytest.raises(ValueError, match="cannot give a halo of 4 rows"):
    _sharded(lambda x: resample.downsample_2d(x, (1,) * 8), x, 4)


def test_the_mesh_and_the_config():
  config = _port_config("256px")
  world4 = ddp.World(rank=3, size=4, launched=True)
  config.tpu.mesh_shape = (2, 2)
  ddp.check_mesh(config, world4)
  assert mesh_lib.make_mesh((2, 2), ddp.World(rank=2, size=4)) == \
      mesh_lib.Mesh(2, 2, 1, 0)
  config.tpu.mesh_shape = (2, 3)
  with pytest.raises(ValueError, match="world size"):
    ddp.check_mesh(config, world4)
  config.tpu.mesh_shape = (1, 3)
  with pytest.raises(ValueError, match="level 0"):  # 256 rows over 3
    ddp.check_mesh(config, ddp.World(size=3, launched=True))
  config.tpu.mesh_shape = (1, 32)  # 32x32 at level 3: 1 row per shard
  with pytest.raises(ValueError, match="level 3 .* thinner than the widest "
                     "halo"):
    ddp.check_mesh(config, ddp.World(size=32, launched=True))
  config.tpu.mesh_shape = (1, 16)  # 2 rows: the FIR halo fits
  ddp.check_mesh(config, ddp.World(size=16, launched=True))
  config.model.name = "ddpm"
  with pytest.raises(NotImplementedError, match="NCSN"):
    ddp.check_mesh(config, ddp.World(size=16, launched=True))


def test_shard_batch_and_draws_on_both_axes():
  batch = torch.arange(4 * 8).reshape(4, 8, 1, 1).float()
  mesh = mesh_lib.Mesh(2, 2, data_index=1, space_index=1)
  rows = mesh_lib.shard_batch(batch, mesh, spatial=True, parts=2)
  # micro-batch 0 is samples 0, 1 and micro-batch 1 samples 2, 3
  torch.testing.assert_close(rows, batch[[1, 3], 4:])

  def whole(kind, shape, high=None):
    return torch.arange(int(np.prod(shape))).reshape(shape) if shape else \
        torch.tensor(-1)

  draw = ddp.sharded_draw(whole, 1, 2, 1, 2)
  assert draw("uniform", (3,)).tolist() == [3, 4, 5]
  assert draw("uniform", ()).item() == -1
  torch.testing.assert_close(draw("normal", (1, 2, 3, 1)),
                             whole("normal", (2, 4, 3, 1))[1:, 2:])
  gen = torch.Generator().manual_seed(0)
  want = torch.rand((4, 8, 3, 2), generator=gen) < 0.9
  with batch_shard(1, 2, 0, 2):
    got = keep_mask((2, 4, 3, 2), 0.9, gen.manual_seed(0), "cpu")
  torch.testing.assert_close(got, want[2:, :4])


def test_layers_refuse_what_a_space_axis_does_not_shard():
  _, config = torch_tiny.configs(torch_tiny.SMALL)
  model = create_model(config, "cpu").eval()
  x = torch.zeros(1, 8, 8, 3)
  space = _Slices(x, 0, 2)
  with spatial.sharded(space), torch.no_grad():
    with pytest.raises(NotImplementedError, match="fused"):
      model(space.rows(x), torch.full((1,), 0.5))
  from soft_truncation_tpu_torch.models.layers import Conv2d
  with spatial.sharded(space), pytest.raises(NotImplementedError,
                                             match="legacy"):
    Conv2d(3, 4)(x[:, :4])


def test_norm_and_attention_statistics_are_the_whole_images():
  """GroupNorm's sums and attention's keys through a space of two ranks
  simulated in one process: ``sum`` and ``gather`` see both shards."""
  x = torch.randn(2, 8, 4, 8, generator=torch.Generator().manual_seed(2))
  norm = GroupNorm(2, 8)
  halves = x.split(4, dim=1)

  class Pair(spatial.Space):
    def sum(self, t):
      return sums[0] + sums[1]

    def gather(self, t):
      return torch.cat(parts, 1)

  sums, parts, outs = [], [], []
  for i, half in enumerate(halves):  # the statistics each shard sends
    xg = half.reshape(2, 16, 2, 4)
    sums.append(torch.stack([xg.sum(dim=(1, 3), keepdim=True),
                             xg.square().sum(dim=(1, 3), keepdim=True)]))
    parts.append(torch.cat([half, half * 2], -1))
  for i, half in enumerate(halves):
    with spatial.sharded(Pair(None, i, 2)):
      outs.append((norm(half), attend(half, half, half * 2)))
  torch.testing.assert_close(torch.cat([o[0] for o in outs], 1), norm(x),
                             rtol=1e-5, atol=1e-5)
  torch.testing.assert_close(torch.cat([o[1] for o in outs], 1),
                             attend(x, x, x * 2), rtol=1e-5, atol=1e-5)
