"""The port's exact-NLL run and its evaluation entry point, on the CPU.

- ``likelihood_fn`` (dopri5 over the flat [x, logp] state, rtol = atol =
  1e-3, where the published 1e-5 doubles the steps) on a tiny VP model
  (``torch_tiny.SMALL`` at one resolution, without attention, at the
  config's own init_scale 0) against the JAX package's, per mode, from
  JAX's draws: the same nfe, the bpd within 1e-4 absolute and z within the
  solver's atol. The step control reads its error norm on the host in f32
  as JAX does on the device. (With weights
  that carry signal, init_scale >= 0.01, the untrained network's ODE is
  stiff near t = eps: an ulp in the first step size, whose RMS norms sum
  in another order, changes the step sequence, and JAX's own jitted and
  eager runs then differ in nfe. The ODE function itself is held at
  init_scale 0.1 in tests/test_torch_likelihood.py.)
- ``python -m soft_truncation_tpu_torch.main --mode eval --cpu`` on a tiny
  trained workdir: the eval loss and bpd of the EMA weights, the log lines
  and the ``bpd_<step>.npz`` report; the in-training bpd at a snapshot;
  FID and IS of the EMA weights' samples (``dpm_solver``, 2 shards, the
  dummy extractor), in training and in the evaluation, which a second run
  resumes from its shards and caches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inverse
from soft_truncation_tpu.likelihood import (
    get_likelihood_fn as jax_get_likelihood_fn)
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu_torch import main as port_main
from soft_truncation_tpu_torch import run_lib
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.likelihood import get_likelihood_fn
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.train import (CheckpointManager,
                                             init_train_state,
                                             make_eval_loss_step)
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.data import get_eval_iterator, make_preprocess_fn

import torch_tiny

# one resolution, no attention: JAX compiles the network's jvp 8 times in one
# dopri5 program
SMALL0 = {"data": torch_tiny.SMALL["data"],
          "model": dict(torch_tiny.SMALL["model"], ch_mult=(1,),
                        attn_resolutions=(), init_scale=0.0)}


LIKELIHOOD_MODES = ("correct", "wrong")


@pytest.fixture(scope="module")
def vp_small():
  """The tiny model, its data and key, and JAX's likelihood_fn in both
  modes, compiled as one program (two compiles cost ~1.5x one)."""
  jc, pc, jmodel, params, pmodel = torch_tiny.build(SMALL0, batch=2)
  x = (2.0 * np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3)) / 255.0
       - 1.0).astype(np.float32)
  key = jax.random.PRNGKey(6)
  jfn = jax_get_likelihood_fn(jc, jax_get_sde(jc), jax_inverse(jc),
                              rtol=1e-3, atol=1e-3)
  want = jax.jit(lambda p, b: {m: jfn(jmodel, p, b, key, mode=m)
                               for m in LIKELIHOOD_MODES})(params, x)
  return pc, pmodel, x, key, want


@pytest.mark.parametrize("mode", LIKELIHOOD_MODES)
def test_likelihood_fn_matches_jax(vp_small, mode):
  pc, pmodel, x, key, jax_runs = vp_small
  want, want_z, want_nfe = jax_runs[mode]
  k_hutch, k_pert, k_resid = jax.random.split(key, 3)
  draws = [("rademacher", jax.random.rademacher(k_hutch, x.shape,
                                                dtype=jnp.float32))]
  if mode == "correct":
    draws += [("normal", jax.random.normal(k_pert, x.shape)),
              ("normal", jax.random.normal(k_resid, x.shape))]
  it = iter(draws)

  def draw(kind, shape):
    want_kind, value = next(it)
    assert (kind, tuple(shape)) == (want_kind, tuple(value.shape))
    return torch.from_numpy(np.array(value))

  bpd, z, nfe = get_likelihood_fn(pc, get_sde(pc), get_data_inverse_scaler(
      pc), rtol=1e-3, atol=1e-3)(pmodel, torch.from_numpy(x), mode=mode,
                                 draw=draw)
  assert next(it, None) is None
  assert nfe == int(want_nfe)
  np.testing.assert_allclose(bpd.numpy(), np.asarray(want), rtol=0,
                             atol=1e-4)
  # z ~ 5e-3 (x e^{-5} at t = 1): each side's steps hold it to atol = 1e-3
  np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=0,
                             atol=1e-3)


TINY_CLI = ["--config.data.dataset", "Synthetic",
            "--config.data.image_size", "8", "--config.model.nf", "8",
            "--config.model.ch_mult", "(1,2)",
            "--config.model.num_res_blocks", "1",
            "--config.model.attn_resolutions", "(4,)",
            "--config.eval.batch_size", "2",
            "--config.eval.nelbo_iter", "1",
            "--config.sampling.method", "dpm_solver",
            "--config.sampling.dpm_steps", "2",
            "--config.sampling.batch_size", "2",
            "--config.eval.num_samples", "4"]


def _cli(workdir, mode, *extra):
  port_main.main(["--config", torch_tiny.PORT_FLAGSHIP, "--workdir",
                  str(workdir), "--mode", mode, "--cpu", *TINY_CLI, *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """A tiny flagship trained 4 steps (lr 2e-4, no warmup: the EMA weights
  differ from the model's), with the in-training NELBO at step 2 and
  snapshot sampling at steps 2 and 3."""
  workdir = tmp_path_factory.mktemp("eval_cli")
  _cli(workdir, "train", "--config.training.n_iters", "3",
       "--config.training.batch_size", "4",
       "--config.training.snapshot_freq", "2",
       "--config.training.snapshot_freq_for_preemption", "3",
       "--config.optim.warmup", "0", "--config.optim.lr", "2e-4",
       "--config.eval.enable_bpd=True", "--config.eval.nll_iter", "0",
       "--config.training.snapshot_sampling=True")
  return workdir


def test_train_cli_writes_the_in_training_bpd(trained):
  with np.load(trained / "bpd" / "bpd_2.npz") as f:
    assert set(f.files) == {"nelbo_bpd_mean", "nelbo_bpd_std"}
    assert np.isfinite(f["nelbo_bpd_mean"])
  log = (trained / "stdout.txt").read_text()
  assert "step 2 nelbo batch 0: mean" in log


def test_eval_cli_reports_loss_and_bpd_of_the_ema_weights(trained):
  _cli(trained, "eval", "--config.eval.enable_bpd=True",
       "--config.eval.nll_iter", "1")
  log = (trained / "evaluation_history.txt").read_text()
  assert "score model step: 4" in log
  for line in ("eval loss: mean", "step 4 nelbo batch 0: mean",
               "step 4 nll batch 0: mean", "ms per function evaluation",
               "step 4 bpd results"):
    assert line in log, line
  with np.load(trained / "eval" / "bpd_4.npz") as f:
    assert set(f.files) == {"nelbo_bpd_mean", "nelbo_bpd_std",
                            "nll_bpd_mean", "nll_bpd_std"}
    assert all(np.isfinite(f[k]) for k in f.files)

  # the eval loss is the EMA weights', not the trained model's
  config = port_main.apply_overrides(
      port_main.load_config(torch_tiny.PORT_FLAGSHIP), TINY_CLI)
  config.eval.loss_iter = 2  # not a key of the configs: the default is 10
  got = run_lib.evaluate(config, str(trained), device="cpu")
  state = init_train_state(config, create_model(config, "cpu"))
  CheckpointManager(str(trained)).restore_meta(state)
  step = make_eval_loss_step(config, get_sde(config))
  preprocess = make_preprocess_fn(config, dequantize=False)

  def loss_mean(weights):
    model = create_model(config, "cpu")
    model.load_state_dict(weights)
    gen = torch.Generator().manual_seed(config.seed + 2)
    return np.concatenate([
        step(model, preprocess(torch.from_numpy(b), None), gen).numpy()
        for _, b in zip(range(2), get_eval_iterator(config))]).mean()

  assert got["eval_loss_mean"] == pytest.approx(loss_mean(state.ema),
                                                rel=1e-6)
  assert abs(got["eval_loss_mean"]
             - loss_mean(state.model.state_dict())) > 1e-3


def _report(directory):
  with np.load(directory / "report_metrics.npz") as f:
    return {k: float(f[k]) for k in f.files}


def test_train_cli_samples_at_snapshots(trained):
  for step in (2, 3):
    d = trained / "samples" / f"ckpt_{step}_dpm_solver_trunc1e-05"
    metrics = _report(d)
    assert set(metrics) == {"fid", "inception_score"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert {f"samples_{r}.{e}" for r in (0, 1) for e in ("npz", "png")} <= set(
        os.listdir(d))
  assert "ckpt-3 metrics" in (trained / "stdout.txt").read_text()


def test_eval_cli_refuses_sampling(trained, tmp_path):
  """Sampling is no longer refused: the evaluation writes two shards, their
  PNG grids and feature caches and the report, with finite FID and IS,
  and a second run resumes from them with the same numbers. The CLI runs
  in float32: it turns TF32 off whatever it was."""
  args = ["--config.eval.enable_sampling=True",
          "--config.eval.enable_loss=False", "--eval_folder", "fid",
          "--assetdir", str(tmp_path / "no_assets")]
  torch.backends.cudnn.allow_tf32 = True
  _cli(trained, "eval", *args)
  assert not torch.backends.cudnn.allow_tf32
  assert not torch.backends.cuda.matmul.allow_tf32
  d = trained / "fid" / "ckpt_4_dpm_solver_trunc1e-05"
  want = {f"{kind}_{r}.{e}" for r in (0, 1)
          for kind, e in (("samples", "npz"), ("samples", "png"),
                          ("statistics", "npz"))} | {"report_metrics.npz"}
  assert set(os.listdir(d)) == want
  metrics = _report(d)
  assert set(metrics) == {"fid", "inception_score"}
  assert all(np.isfinite(v) for v in metrics.values())
  with np.load(d / "samples_1.npz") as f:
    assert f["samples"].shape == (2, 8, 8, 3)
    assert f["samples"].dtype == np.uint8
  log = (trained / "evaluation_history.txt").read_text()
  assert "DummyFeatureExtractor in use" in log and "ckpt-4 metrics" in log
  stamps = {p: os.stat(d / p).st_mtime_ns for p in want}
  _cli(trained, "eval", *args)
  assert _report(d) == metrics
  assert {p: os.stat(d / p).st_mtime_ns for p in want if p.startswith(
      ("samples", "statistics"))} == {p: t for p, t in stamps.items()
                                      if p.startswith(("samples",
                                                       "statistics"))}
