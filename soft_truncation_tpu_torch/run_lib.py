"""The training and evaluation pipelines.

Counterpart of ``soft_truncation_tpu/run_lib.py``. :func:`train`: build the
SDE, the model (weights from ``config.seed``), the train state and the
checkpoints; resume from the rolling checkpoint when there is one; then
train steps ``initial_step .. training.n_iters`` (both ends included),
logging the per-example losses' mean and std every ``log_freq`` steps,
saving the rolling checkpoint every ``snapshot_freq_for_preemption`` and a
numbered snapshot every ``snapshot_freq`` and at the last step; at each
snapshot (with ``eval.enable_bpd``) the bpd of the EMA weights into
``workdir/bpd``, and at each snapshot and the last step (with
``training.snapshot_sampling``) FID, KID and IS of the EMA weights'
samples into ``workdir/samples``; with ``config.tpu.profile_dir`` (read
with ``get``, as JAX reads it) a ``torch.profiler`` trace of the run's
eleventh step, the step JAX traces. Under ``torchrun``, data parallel over
the ranks (``parallel/ddp.py``). :func:`evaluate`: the eval loss, the bpd
and (with ``eval.enable_sampling``) FID, KID and IS of the EMA weights of
the rolling checkpoint (or of the seed's weights without one), into
``workdir/<eval_folder>``. Sampling for FID uses ``sampling.method`` at
``sampling.batch_size`` per shard, ``eval.num_samples`` images; the
Inception weights and the real images' statistics come from ``assetdir``
(eval/evaluation.py).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from . import data as datasets
from .eval import evaluation
from .likelihood import get_elbo_fn, get_likelihood_fn
from .models import create_model
from .parallel import ddp
from .sample import get_sampling_fn
from .sde import get_sde
from .train import (CheckpointManager, init_train_state, make_eval_loss_step,
                    make_train_step)
from .train.state import param_count
from .utils.device import resolve_device
from .utils.profiling import StepTimer, trace

log = logging.getLogger(__name__)


def _crossed(step: int, freq: int, allow_zero: bool = False) -> bool:
  """Whether ``step`` is on the ``freq`` cadence (step 0 only with
  ``allow_zero``; never for ``freq`` <= 0)."""
  return freq > 0 and step % freq == 0 and (step > 0 or allow_zero)


def _sampling_fn(config, sde):
  """The sampler of ``config.sampling`` for one shard of FID samples."""
  shape = (config.sampling.batch_size, config.data.image_size,
           config.data.image_size, config.data.num_channels)
  return get_sampling_fn(config, sde, shape,
                         datasets.get_data_inverse_scaler(config),
                         config.sampling.truncation_time)


def train(config, workdir: str, assetdir=None, device="cuda"):
  """Train under ``config`` in ``workdir``; returns the final state.

  ``device`` is 'cuda' unless the caller asks for 'cpu'; without a card
  'cuda' raises. ``assetdir`` holds the Inception weights and the real
  images' statistics of snapshot sampling. Launched by ``torchrun``, each
  rank trains on its rows of the global batch (``parallel/ddp.py``) and
  rank 0 alone writes the checkpoints, the log lines, the bpd and the
  samples; every rank restores the rolling checkpoint."""
  with ddp.process_group(config, device) as (world, device):
    return _train(config, workdir, assetdir, world, device)


def _train(config, workdir, assetdir, world, device):
  sde = get_sde(config)
  model = create_model(config, device, seed=config.seed)
  state = init_train_state(config, model)
  log.info("model parameters: %d", param_count(model))
  ckpt = CheckpointManager(workdir)
  ckpt.restore_meta(state)
  initial_step = state.step
  state.replica = ddp.replicate(model, world)

  log.info("loading %s...", config.data.dataset)
  # a resumed run draws data and noise afresh, from the seed and its step
  seed = np.random.SeedSequence([config.seed, initial_step])
  batches = datasets.get_train_iterator(config, seed)
  preprocess = datasets.make_preprocess_fn(config)
  train_step = make_train_step(config, sde)
  # the parts of the global batch each rank takes its rows of
  parts = config.optim.num_micro_batch * (
      2 if config.training.get("mixed", False) else 1)
  generator = torch.Generator(device).manual_seed(
      int(seed.generate_state(1)[0]))
  timer = StepTimer(config.training.batch_size)
  profile_dir = config.get("tpu", {}).get("profile_dir") or None
  inverse_scaler = datasets.get_data_inverse_scaler(config)
  nll_fn = get_likelihood_fn(config, sde, inverse_scaler)
  nelbo_fn = get_elbo_fn(config, sde, inverse_scaler)
  eval_model = None
  n_iters = config.training.n_iters
  log.info("Starting training loop at step %d.", initial_step)
  for step in range(initial_step, n_iters + 1):
    batch = preprocess(torch.from_numpy(next(batches)).to(device), generator)
    # the step JAX traces: the eleventh of this run
    traced = (profile_dir if world.is_main and step == initial_step + 10
              else None)
    with trace(traced):
      losses = train_step(state, ddp.shard(batch, world, parts), generator)
    timer.tick()

    if _crossed(step, config.training.log_freq, allow_zero=True):
      losses = ddp.gather(losses).cpu()
      sps, ips = timer.report()
      if world.is_main:
        log.info("step: %d, training loss mean: %.5e, training loss std: "
                 "%.5e (%.2f steps/s, %.0f imgs/s)", step,
                 losses.mean().item(), losses.std(unbiased=False).item(),
                 sps, ips)
    if not world.is_main:
      continue

    if _crossed(step, config.training.snapshot_freq_for_preemption):
      ckpt.save_meta(state)

    snapshot = _crossed(step, config.training.snapshot_freq)
    if snapshot or step == n_iters:
      ckpt.save_snapshot(state, step // config.training.snapshot_freq)

    bpd = snapshot and config.eval.enable_bpd
    sampling = ((snapshot or step == n_iters)
                and config.training.snapshot_sampling)
    if bpd or sampling:
      # the EMA weights, in an eval copy made at the first use
      if eval_model is None:
        eval_model = _eval_model(config, device)
      eval_model.load_state_dict(state.ema)
    if bpd:
      evaluation.compute_bpd(config, nelbo_fn, nll_fn, eval_model, step=step,
                             report_dir=os.path.join(workdir, "bpd"),
                             device=device)
    if sampling:
      log.info("sampling start ...")
      evaluation.compute_fid_and_is(
          config, eval_model, _sampling_fn(config, sde), step,
          os.path.join(workdir, "samples"), assetdir,
          config.eval.num_samples,
          eval_ds=datasets.get_eval_iterator(config), device=device)
  return state


def _eval_model(config, device) -> torch.nn.Module:
  """A model for evaluation: its parameters take no gradient."""
  return create_model(config, device).requires_grad_(False)


def evaluate(config, workdir: str, assetdir=None, eval_folder: str = "eval",
             device="cuda") -> dict:
  """The eval loss (``eval.enable_loss``, ``eval.loss_iter`` batches), the
  bpd (``eval.enable_bpd``) and FID, KID and IS (``eval.enable_sampling``)
  of the EMA weights of ``workdir``'s rolling checkpoint, or of the seed's
  weights when there is none, reported in ``workdir/eval_folder``; returns
  the results. ``device`` and ``assetdir`` as for :func:`train`."""
  eval_dir = os.path.join(workdir, eval_folder)
  os.makedirs(eval_dir, exist_ok=True)
  device = resolve_device(device)
  sde = get_sde(config)
  state = init_train_state(config, create_model(config, device,
                                                seed=config.seed))
  CheckpointManager(workdir).restore_meta(state)
  step = state.step
  log.info("score model step: %d", step)
  model = _eval_model(config, device)
  model.load_state_dict(state.ema)  # evaluation uses the EMA weights
  del state

  results = {}
  if config.eval.enable_loss and config.training.continuous:
    eval_step = make_eval_loss_step(config, sde)
    preprocess = datasets.make_preprocess_fn(config, dequantize=False)
    generator = torch.Generator(device).manual_seed(config.seed + 2)
    vals = []
    for _, batch in zip(range(config.eval.get("loss_iter", 10)),
                        datasets.eval_batches(config)):
      batch = preprocess(torch.from_numpy(batch).to(device), None)
      vals.append(eval_step(model, batch, generator).cpu().numpy())
    if vals:
      vals = np.concatenate(vals)
      results["eval_loss_mean"] = float(vals.mean())
      results["eval_loss_std"] = float(vals.std())
      log.info("eval loss: mean %.5e std %.5e over %d examples", vals.mean(),
               vals.std(), vals.size)

  if config.eval.enable_bpd:
    inverse_scaler = datasets.get_data_inverse_scaler(config)
    results.update(evaluation.compute_bpd(
        config, get_elbo_fn(config, sde, inverse_scaler),
        get_likelihood_fn(config, sde, inverse_scaler), model,
        step=step, report_dir=eval_dir, device=device))

  if config.eval.enable_sampling:
    log.info("sampling start ...")
    results.update(evaluation.compute_fid_and_is(
        config, model, _sampling_fn(config, sde), step, eval_dir, assetdir,
        config.eval.num_samples, eval_ds=datasets.get_eval_iterator(config),
        device=device))
  return results
