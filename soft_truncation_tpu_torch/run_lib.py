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
with ``get``, as JAX reads it) a ``torch.profiler`` trace of the window
that holds the run's eleventh step, the step JAX traces. The steps run in
windows of ``config.tpu.steps_per_dispatch`` (K; the last may be
narrower), as JAX's loop runs them: each window is one call of
``make_multi_train_step`` (one CUDA graph replay on the card for K > 1
alone or on one NCCL rank, else the K steps one by one: its route, logged
once with the backend),
its batches one ``[K, B, H, W, C]`` stack uploaded at once, which a
background thread assembles (into pinned memory on the card) while the
window before it trains. Logging, checkpoints, snapshots, the bpd and
snapshot sampling fire at the window that crosses their step, labelled
with it (:func:`_crossed`); at K = 1 that is every step, as before.
Under ``torchrun``, data parallel over
the ranks (``parallel/ddp.py``), or with ``tpu.mesh_shape = (d, s)`` over
a ``(data, space)`` mesh whose space ranks each hold H/s rows of every
image (``parallel/mesh.py``); snapshot sampling and the bpd run on rank 0
either way. :func:`evaluate`: the eval loss, the bpd
and (with ``eval.enable_sampling``) FID, KID and IS of the EMA weights of
the rolling checkpoint (or of the seed's weights without one), into
``workdir/<eval_folder>``. Sampling for FID uses ``sampling.method`` at
``sampling.batch_size`` per shard, ``eval.num_samples`` images; the
Inception weights and the real images' statistics come from ``assetdir``
(eval/evaluation.py).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
from typing import Optional

import numpy as np
import torch

from . import data as datasets
from .eval import evaluation
from .likelihood import get_elbo_fn, get_likelihood_fn
from .models import create_model
from .models.score import load_eval_params
from .parallel import ddp
from .parallel.mesh import first_of_space, local_shape, make_mesh
from .sample import get_sampling_fn
from .sde import get_sde
from .train import (CheckpointManager, init_train_state, make_eval_loss_step,
                    make_multi_train_step, window_scalars)
from .train.state import param_count
from .utils.device import resolve_device
from .utils.profiling import StepTimer, annotate, trace

log = logging.getLogger(__name__)


def _crossed(step0: int, last: int, freq: int,
             allow_zero: bool = False) -> Optional[int]:
  """The largest step in [step0, last] on the ``freq`` cadence, or None
  (never for ``freq`` <= 0; step 0 only with ``allow_zero``): JAX's
  ``run_lib._crossed``. A window of steps step0..last fires a periodic
  event at the step it crosses, labelled with it; for a window of one
  step this is ``step % freq == 0``."""
  if freq <= 0:
    return None
  m = (last // freq) * freq
  if m < step0 or (m == 0 and not allow_zero):
    return None
  return m


class _Windows:
  """The host's side of the windows: two ``[K, B, H, W, C]`` stacks
  (pinned on the card) and their scalar tables. A background thread fills
  a stack from the batches (``fill(out)`` of a ``NativeBatcher``, else
  ``next``) while the window before it trains; a stack is filled again
  once the device has read it (an event recorded after its window)."""

  def __init__(self, batches, width: int, shape, dtype: torch.dtype,
               device: torch.device):
    pinned = device.type == "cuda"
    self.batches = batches
    self.stacks = [torch.empty((width,) + tuple(shape), dtype=dtype,
                               pin_memory=pinned) for _ in range(2)]
    self.dtype = self.stacks[0].numpy().dtype
    self.tables = [torch.empty((width, 4), pin_memory=pinned)
                   for _ in range(2)]
    self.read = [None, None]  # each stack's event: the device has read it
    self.pool = concurrent.futures.ThreadPoolExecutor(1)
    self.slot, self.pending = 0, None

  def _fill(self, slot: int, width: int) -> None:
    if self.read[slot] is not None:
      self.read[slot].synchronize()
    out = self.stacks[slot].numpy()
    fill = getattr(self.batches, "fill", None)
    for k in range(width):
      if fill is not None:
        fill(out[k])
      else:
        batch = next(self.batches)
        if batch.dtype != self.dtype:
          raise ValueError(f"a batch of {batch.dtype}, not {self.dtype}")
        out[k] = batch

  def prefetch(self, width: int) -> None:
    """Start filling the next stack with ``width`` batches."""
    self.slot ^= 1
    self.pending = (self.slot, width,
                    self.pool.submit(self._fill, self.slot, width))

  def take(self, width: int):
    """The stack prefetched last and its table, ``width`` steps of each."""
    slot, filled, future = self.pending
    future.result()
    if filled != width:
      raise AssertionError(f"prefetched {filled} steps, asked for {width}")
    return self.stacks[slot][:width], self.tables[slot][:width], slot

  def release(self, slot: int) -> None:
    """The window of ``slot`` is queued: its stack is free once the
    device gets past this point."""
    if self.stacks[slot].is_pinned():
      self.read[slot] = torch.cuda.Event()
      self.read[slot].record()

  def close(self) -> None:
    self.pool.shutdown(wait=True)


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
  mesh = make_mesh(config.get("tpu", {}).get("mesh_shape", ()), world)
  multi_step = make_multi_train_step(config, sde, mesh, device)
  if mesh.space > 1 or (world.launched and multi_step.route == "graph"):
    # no DDP wrapper (none in a captured window): the step all-reduces the
    # gradients itself
    ddp.broadcast(model, world)
    state.mesh = mesh
    log.info("mesh (data %d, space %d): rank %d at (%d, %d), local batch "
             "%s", mesh.data, mesh.space, world.rank, mesh.data_index,
             mesh.space_index, list(local_shape(
                 config, mesh, config.training.batch_size)))
  else:
    state.replica = ddp.replicate(model, world)
  log.info("train windows of %d steps: route %s (process group %s)",
           multi_step.width, multi_step.route, ddp.backend() or "none")

  log.info("loading %s...", config.data.dataset)
  # a resumed run draws data and noise afresh, from the seed and its step
  seed = np.random.SeedSequence([config.seed, initial_step])
  batches = datasets.get_train_iterator(config, seed)
  width = multi_step.width
  generator = torch.Generator(device).manual_seed(
      int(seed.generate_state(1)[0]))
  timer = StepTimer(config.training.batch_size)
  profile_dir = config.get("tpu", {}).get("profile_dir") or None
  inverse_scaler = datasets.get_data_inverse_scaler(config)
  nll_fn = get_likelihood_fn(config, sde, inverse_scaler)
  nelbo_fn = get_elbo_fn(config, sde, inverse_scaler)
  eval_model = None
  n_iters = config.training.n_iters
  size = config.data.image_size
  windows = _Windows(batches, width, (config.training.batch_size, size, size,
                                      config.data.num_channels),
                     torch.uint8 if datasets.transport_uint8(config)
                     else torch.float32, torch.device(device))
  log.info("Starting training loop at step %d.", initial_step)
  step0 = initial_step
  if step0 <= n_iters:
    windows.prefetch(min(width, n_iters + 1 - step0))
  try:
    while step0 <= n_iters:
      w = min(width, n_iters + 1 - step0)
      last = step0 + w - 1
      stack, table, slot = windows.take(w)
      if last < n_iters:
        windows.prefetch(min(width, n_iters - last))
      table.numpy()[:] = window_scalars(state, w)
      # the window of the step JAX traces: the eleventh of this run
      traced = (profile_dir if world.is_main
                and step0 <= initial_step + 10 <= last else None)
      with trace(traced), annotate(f"train window {step0}-{last}"):
        losses = multi_step(state, stack, generator, scalars=table)
      windows.release(slot)
      for _ in range(w):
        timer.tick()
      window0, step0 = step0, last + 1

      def crossed(freq, allow_zero=False):
        return _crossed(window0, last, freq, allow_zero)

      log_step = crossed(config.training.log_freq, allow_zero=True)
      if log_step is not None:
        losses = first_of_space(ddp.gather(losses.reshape(-1)), mesh).cpu()
        sps, ips = timer.report()
        if world.is_main:
          log.info("step: %d, training loss mean: %.5e, training loss std: "
                   "%.5e (%.2f steps/s, %.0f imgs/s)", log_step,
                   losses.mean().item(), losses.std(unbiased=False).item(),
                   sps, ips)
      if not world.is_main:
        continue

      if crossed(config.training.snapshot_freq_for_preemption) is not None:
        ckpt.save_meta(state)

      snap_step = crossed(config.training.snapshot_freq)
      label = snap_step if snap_step is not None else last
      if snap_step is not None or last == n_iters:
        ckpt.save_snapshot(state, label // config.training.snapshot_freq)

      bpd = snap_step is not None and config.eval.enable_bpd
      sampling = ((snap_step is not None or last == n_iters)
                  and config.training.snapshot_sampling)
      if bpd or sampling:
        # the EMA weights, in an eval copy made at the first use
        if eval_model is None:
          eval_model = _eval_model(config, device)
        load_eval_params(eval_model, state.ema)
      if bpd:
        evaluation.compute_bpd(config, nelbo_fn, nll_fn, eval_model,
                               step=snap_step,
                               report_dir=os.path.join(workdir, "bpd"),
                               device=device)
      if sampling:
        log.info("sampling start ...")
        evaluation.compute_fid_and_is(
            config, eval_model, _sampling_fn(config, sde), label,
            os.path.join(workdir, "samples"), assetdir,
            config.eval.num_samples,
            eval_ds=datasets.get_eval_iterator(config), device=device)
  finally:
    windows.close()
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
  load_eval_params(model, state.ema)  # evaluation uses the EMA weights
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
