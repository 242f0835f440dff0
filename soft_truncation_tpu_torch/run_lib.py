"""The training pipeline.

Counterpart of ``soft_truncation_tpu/run_lib.py::train``: build the SDE, the
model (weights from ``config.seed``), the train state and the checkpoints;
resume from the rolling checkpoint when there is one; then train steps
``initial_step .. training.n_iters`` (both ends included), logging the
per-example losses' mean and std every ``log_freq`` steps, saving the
rolling checkpoint every ``snapshot_freq_for_preemption`` and a numbered
snapshot every ``snapshot_freq`` and at the last step. The in-training bpd
(``eval.enable_bpd``) and sampling (``training.snapshot_sampling``) raise:
they arrive with ROADMAP.md slices 4 and 5. Evaluation (``run_lib.evaluate``)
arrives with slice 5.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import data as datasets
from .models import create_model
from .sde import get_sde
from .train import CheckpointManager, init_train_state, make_train_step
from .train.state import param_count
from .utils.device import resolve_device

log = logging.getLogger(__name__)


def _crossed(step: int, freq: int, allow_zero: bool = False) -> bool:
  """Whether ``step`` is on the ``freq`` cadence (step 0 only with
  ``allow_zero``; never for ``freq`` <= 0)."""
  return freq > 0 and step % freq == 0 and (step > 0 or allow_zero)


class StepTimer:
  """Steps and images per second since the last report."""

  def __init__(self, batch_size: int):
    self.batch_size = batch_size
    self._t0 = time.perf_counter()
    self._steps = 0

  def tick(self) -> None:
    self._steps += 1

  def report(self):
    now = time.perf_counter()
    sps = self._steps / max(now - self._t0, 1e-9)
    self._t0, self._steps = now, 0
    return sps, sps * self.batch_size


def train(config, workdir: str, assetdir=None, device="cuda"):
  """Train under ``config`` in ``workdir``; returns the final state.

  ``device`` is 'cuda' unless the caller asks for 'cpu'; without a card
  'cuda' raises. ``assetdir`` is read by no part of this slice."""
  del assetdir
  if config.eval.enable_bpd:
    raise NotImplementedError("the in-training bpd (eval.enable_bpd) "
                              "arrives with ROADMAP.md slice 4")
  if config.training.snapshot_sampling:
    raise NotImplementedError("snapshot sampling (training.snapshot_"
                              "sampling) arrives with ROADMAP.md slice 5")
  device = resolve_device(device)
  sde = get_sde(config)
  model = create_model(config, device, seed=config.seed)
  state = init_train_state(config, model)
  log.info("model parameters: %d", param_count(model))
  ckpt = CheckpointManager(workdir)
  ckpt.restore_meta(state)
  initial_step = state.step

  log.info("loading %s...", config.data.dataset)
  # a resumed run draws data and noise afresh, from the seed and its step
  seed = np.random.SeedSequence([config.seed, initial_step])
  batches = datasets.get_train_iterator(config, seed)
  preprocess = datasets.make_preprocess_fn(config)
  train_step = make_train_step(config, sde)
  generator = torch.Generator(device).manual_seed(
      int(seed.generate_state(1)[0]))
  timer = StepTimer(config.training.batch_size)
  n_iters = config.training.n_iters
  log.info("Starting training loop at step %d.", initial_step)
  for step in range(initial_step, n_iters + 1):
    batch = torch.from_numpy(next(batches)).to(device)
    losses = train_step(state, preprocess(batch, generator), generator)
    timer.tick()

    if _crossed(step, config.training.log_freq, allow_zero=True):
      losses = losses.cpu()
      sps, ips = timer.report()
      log.info("step: %d, training loss mean: %.5e, training loss std: "
               "%.5e (%.2f steps/s, %.0f imgs/s)", step,
               losses.mean().item(), losses.std(unbiased=False).item(), sps,
               ips)

    if _crossed(step, config.training.snapshot_freq_for_preemption):
      ckpt.save_meta(state)

    if _crossed(step, config.training.snapshot_freq) or step == n_iters:
      ckpt.save_snapshot(state, step // config.training.snapshot_freq)
  return state
