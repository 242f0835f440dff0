"""The training step: the ST ``t_min`` draw, micro-batch gradient
accumulation, the optimizer and the EMA.

Counterpart of ``soft_truncation_tpu/train/step.py::make_train_step``, run
eagerly. One ``t_min`` per step is drawn before the micro-batches (when
Soft-Truncation is active, :func:`st_active_for`; else the truncation
time). Each micro-batch's per-example losses are averaged and
back-propagated, so the gradients of the micro-batches' means are summed,
as JAX sums them. The mixed variant scores the first half of each
micro-batch with importance sampling and the second without, combined as
``l_is + ddpm_weight * l_dd`` (times ``stop_gradient(mean(l_is / l_dd))``
when balanced). With ``training.continuous=False`` each micro-batch takes
the discrete loss instead: SMLD for a VE SDE, DDPM for a VP SDE (any other
raises, as does ``likelihood_weighting``); the ``t_min`` draw stays where
JAX makes it (Soft-Truncation active), unread. ``make_multi_train_step``
(K steps per dispatch) has no meaning without a dispatch cost to amortise:
the port has none, and reads neither ``config.tpu.steps_per_dispatch`` nor
``donate_state``.

Data parallelism: with ``state.replica`` (``parallel.ddp.replicate``) the
step runs its forwards through that DistributedDataParallel wrapper, on
this rank's rows of the global batch (``parallel.ddp.shard``); every draw
is the global batch's cut to those rows, the micro-batches but the last
accumulate under ``no_sync``, and the balanced mixed loss's batch mean is
averaged over the ranks, so that the step equals one process's on the
whole batch.

Under a space axis (``state.mesh``, ``parallel/mesh.py``: the batch split
over ``data`` and each image's rows over ``space``) there is no DDP
wrapper: the forwards and losses run within ``parallel.spatial.sharded``
(halo rows, space-wide sums and gathers), every draw and dropout mask is
the global batch's cut to this rank's samples and rows, and after the last
backward one all-reduce averages the gradients over the world. Each
collective's backward is its exact adjoint, so each rank holds its share of
the gradient of the sum of the s equal copies of its data group's loss:
the world's mean is the gradient of one process on the whole batch. The
balanced mixed loss's ratio is averaged over the world as before (equal on
the ranks of a space group).
:func:`make_eval_loss_step` is the per-example eval loss.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..losses.losses import (Draw, get_ddpm_loss_fn, get_sde_loss_fn,
                             get_smld_loss_fn, make_draw)
from ..models.dropout import batch_shard
from ..models.ema import ema_update
from ..parallel import spatial
from ..parallel.ddp import sharded_draw
from ..sde.core import SDE, VESDE, VPSDE, st_active_for
from .state import TrainState


def make_train_step(config, sde: SDE) -> Callable:
  """Returns ``train_step(state, batch, generator, draw=None)`` -> the
  per-example losses ([B], or [B/2] for mixed; this rank's under data
  parallelism), updating ``state`` in place.

  ``batch`` is [B, H, W, C] on the model's device; ``generator`` (on that
  device) feeds the dropout masks and, unless ``draw`` is given, every
  other draw of the step, in the order JAX's keys make them: the ``t_min``
  uniform, then per micro-batch (and per half when mixed) t's uniforms,
  z and the reconstruction's z, or for the discrete losses the labels and
  the noise."""
  num_micro = config.optim.num_micro_batch
  mixed = config.training.get("mixed", False)
  st = st_active_for(sde, config)
  k_exp = config.training.get("k", 1.0)
  trunc = config.training.truncation_time
  importance_sampling = config.training.importance_sampling
  ddpm_weight = config.training.get("ddpm_weight", 0.01)
  balanced = config.training.get("balanced", False)
  continuous = config.training.continuous
  if continuous:
    loss_fn = get_sde_loss_fn(config, sde, train=True)
  else:
    if config.training.likelihood_weighting:
      raise ValueError("Likelihood weighting is not supported for original "
                       "SMLD/DDPM training.")
    if isinstance(sde, VESDE):
      discrete_loss = get_smld_loss_fn(config, sde, train=True)
    elif isinstance(sde, VPSDE):
      discrete_loss = get_ddpm_loss_fn(config, sde, train=True)
    else:
      raise ValueError(f"Discrete training for {type(sde).__name__} is not "
                       "recommended.")

  def micro_losses(model, mb, t_min, draw, generator, ranks):
    if not continuous:
      return discrete_loss(model, mb, draw, generator)
    if not mixed:
      return loss_fn(model, mb, t_min, importance_sampling, draw, generator)
    half = mb.shape[0] // 2
    l_is = loss_fn(model, mb[:half], t_min, True, draw, generator)
    l_dd = loss_fn(model, mb[half:], t_min, False, draw, generator)
    if balanced:
      ratio = torch.mean(l_is / l_dd).detach()
      if ranks > 1:  # the global batch's mean: equal rows on every rank
        dist.all_reduce(ratio)
        ratio = ratio / ranks
      return l_is + ddpm_weight * ratio * l_dd
    return l_is + ddpm_weight * l_dd

  def train_step(state: TrainState, batch: torch.Tensor,
                 generator: torch.Generator,
                 draw: Optional[Draw] = None) -> torch.Tensor:
    draw = draw or make_draw(generator, batch.device)
    replica = state.replica
    mesh = state.mesh
    space = mesh.space_shard() if mesh is not None else None
    shards = (0, 1, 0, 1)  # (data rank, data ranks, space rank, space ranks)
    if space is not None:
      shards = (mesh.data_index, mesh.data, mesh.space_index, mesh.space)
    elif replica is not None:
      shards = (dist.get_rank(), dist.get_world_size(), 0, 1)
    ranks = shards[1] * shards[3]
    if ranks > 1:
      draw = sharded_draw(draw, *shards)
    if st:
      t_min = sde.sample_t_min(draw("uniform", ()), k_exp, trunc)
    else:
      t_min = torch.tensor(trunc, dtype=torch.float32, device=batch.device)
    b = batch.shape[0]
    if b % num_micro:
      raise ValueError(f"batch {b} is not a multiple of num_micro_batch "
                       f"{num_micro}")
    for p in state.optimizer.params:
      p.grad = None
    losses = []
    micro_batches = batch.reshape((num_micro, b // num_micro)
                                  + batch.shape[1:])
    with batch_shard(*shards), spatial.sharded(space):
      for j, mb in enumerate(micro_batches):
        # DDP reduces the accumulated gradients after the last backward
        sync = replica is None or j == num_micro - 1
        with contextlib.nullcontext() if sync else replica.no_sync():
          micro = micro_losses(replica or state.model, mb, t_min, draw,
                               generator, ranks)
          micro.mean().backward()
        losses.append(micro.detach())
    if space is not None:
      _average_gradients(state.optimizer.params, ranks)
    state.optimizer.step()
    for p in state.optimizer.params:
      p.grad = None
    state.step += 1
    ema_update(state.ema, state.model, state.ema_rate, state.step)
    return torch.cat(losses)

  return train_step


def _average_gradients(params, ranks: int) -> None:
  """Each parameter's gradient averaged over the world, in one
  all-reduce."""
  grads = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in params]
  flat = torch.cat([g.reshape(-1) for g in grads])
  dist.all_reduce(flat)
  flat /= ranks
  for p, g in zip(params, flat.split([g.numel() for g in grads])):
    p.grad = g.view_as(p)


def make_eval_loss_step(config, sde: SDE) -> Callable:
  """Returns ``eval_step(model, batch, generator, draw=None)`` -> the
  per-example losses of ``get_sde_loss_fn(train=False)`` at t_min =
  ``training.truncation_time``, under ``torch.no_grad()`` (the network's
  fused sites launch their kernels directly). Counterpart of the JAX
  package's ``make_eval_loss_step``; the draws as in :func:`make_train_step`
  without ``t_min``'s."""
  loss_fn = get_sde_loss_fn(config, sde, train=False)
  importance_sampling = config.training.importance_sampling
  trunc = config.training.truncation_time

  @torch.no_grad()
  def eval_step(model, batch: torch.Tensor, generator: torch.Generator,
                draw: Optional[Draw] = None) -> torch.Tensor:
    draw = draw or make_draw(generator, batch.device)
    t_min = torch.tensor(trunc, dtype=torch.float32, device=batch.device)
    return loss_fn(model, batch, t_min, importance_sampling, draw)

  return eval_step
