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
JAX makes it (Soft-Truncation active), unread. The step's scalars (the
learning rate, Adam's bias corrections, the EMA's weight) are one device
tensor of four the host computes from the step (:func:`window_scalars`),
so that a captured step reads them rather than holding its capture's.

:func:`make_multi_train_step` trains a window of K steps
(``config.tpu.steps_per_dispatch``; JAX's ``make_multi_train_step``): each
step's preprocess (the dequantization noise, the scaler) and then the step,
K times, on a ``[K, B, H, W, C]`` stack of raw batches. The window's route
is fixed when it is made, from the device, K and the process group
(:func:`window_route`). On route 'graph' a window is one CUDA graph
replay of those K steps (one graph per window width, captured at the
width's first window after a warm-up step that is then undone): the host
issues one replay where the steps would issue ~10^4 launches each, and the
replay draws from the train generator what K eager steps draw. That route
is taken for K > 1 on the card alone or as the one rank of an NCCL group.
On route 'eager' (the CPU, K = 1, gloo ranks, whose collectives run on the
host outside any graph, and NCCL groups of several ranks, where a captured
window has not yet run) the same K steps are issued one by one. The ranks
of a captured window train without the DDP wrapper (its reducer's hooks
and bookkeeping are not safe to capture): they take ``state.mesh``, a
``(world size, 1)`` mesh, and its one all-reduce of the flattened
gradients.

Data parallelism: with ``state.replica`` (``parallel.ddp.replicate``) the
step runs its forwards through that DistributedDataParallel wrapper, on
this rank's rows of the global batch (``parallel.ddp.shard``); every draw
is the global batch's cut to those rows, the micro-batches but the last
accumulate under ``no_sync``, and the balanced mixed loss's batch mean is
averaged over the ranks, so that the step equals one process's on the
whole batch.

Under ``state.mesh`` (``parallel/mesh.py``: the batch split over
``data`` and, with a space axis, each image's rows over ``space``) there
is no DDP wrapper: the forwards and losses run within
``parallel.spatial.sharded`` (halo rows, space-wide sums and gathers; none
without a space axis), every draw and dropout mask is
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

import collections
import contextlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.datasets import make_preprocess_fn
from ..losses.losses import (Draw, get_ddpm_loss_fn, get_sde_loss_fn,
                             get_smld_loss_fn, make_draw)
from ..models.dropout import batch_shard
from ..models.ema import ema_apply, ema_weight
from ..ops import launch_totals
from ..parallel import spatial
from ..parallel.ddp import backend as ddp_backend
from ..parallel.ddp import sharded_draw
from ..parallel.mesh import shard_batch
from ..sde.core import SDE, VESDE, VPSDE, st_active_for
from .state import TrainState


def window_scalars(state: TrainState, width: int) -> np.ndarray:
  """The f32 scalars of the next ``width`` steps of ``state``, one row a
  step: the optimizer's :meth:`~losses.Optimizer.scalars` (learning rate,
  both bias corrections) at its count, and the EMA's ``1 - d`` at the
  step it takes ``state`` to."""
  opt = state.optimizer
  return np.stack([np.append(opt.scalars(opt.count + k),
                             ema_weight(state.ema_rate, state.step + k + 1))
                   for k in range(width)]).astype(np.float32)


def make_train_step(config, sde: SDE) -> Callable:
  """Returns ``train_step(state, batch, generator, draw=None,
  scalars=None)`` -> the per-example losses ([B], or [B/2] for mixed; this
  rank's under data parallelism), updating ``state`` in place; ``scalars``
  is :func:`window_scalars`'s row of the step on the model's device, made
  here where it is not given.

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
        spatial.calls["ratio"] += 1
        dist.all_reduce(ratio)
        ratio = ratio / ranks
      return l_is + ddpm_weight * ratio * l_dd
    return l_is + ddpm_weight * l_dd

  def train_step(state: TrainState, batch: torch.Tensor,
                 generator: torch.Generator, draw: Optional[Draw] = None,
                 scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
    draw = draw or make_draw(generator, batch.device)
    if scalars is None:
      scalars = torch.from_numpy(window_scalars(state, 1)[0]).to(
          batch.device)
    replica = state.replica
    mesh = state.mesh
    space = mesh.space_shard() if mesh is not None else None
    shards = (0, 1, 0, 1)  # (data rank, data ranks, space rank, space ranks)
    if mesh is not None:
      shards = (mesh.data_index, mesh.data, mesh.space_index, mesh.space)
    elif replica is not None:
      shards = (dist.get_rank(), dist.get_world_size(), 0, 1)
    ranks = shards[1] * shards[3]
    if ranks > 1:
      draw = sharded_draw(draw, *shards)
    if st:
      t_min = sde.sample_t_min(draw("uniform", ()), k_exp, trunc)
    else:
      t_min = torch.full((), trunc, dtype=torch.float32, device=batch.device)
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
    if mesh is not None:
      _average_gradients(state.optimizer.params, ranks)
    state.optimizer.step(scalars=scalars[:3])
    for p in state.optimizer.params:
      p.grad = None
    state.step += 1
    ema_apply(state.ema, state.model, scalars[3])
    return torch.cat(losses)

  return train_step


def window_route(device_type: str, width: int, backend: Optional[str],
                 ranks: int = 1) -> str:
  """How a window of ``width`` steps is issued: 'graph' (one CUDA graph
  replay) for K > 1 on 'cuda' with no process group (``backend`` None) or
  as the one rank of an NCCL group; 'eager' (the steps one by one) on the
  CPU, at K = 1, under gloo, whose collectives run on the host outside any
  graph, and on NCCL groups of several ``ranks``, where a captured window
  has not yet run (``ROADMAP.md``, Queue 1 item 2)."""
  if width > 1 and device_type == "cuda" and (
      backend is None or (backend == "nccl" and ranks == 1)):
    return "graph"
  return "eager"


def make_multi_train_step(config, sde: SDE, mesh=None,
                          device="cuda") -> Callable:
  """Returns ``multi_step(state, batches, generator, draws=None,
  scalars=None)`` -> the losses ``[K, B']`` of a window of K steps (module
  docstring), updating ``state`` (on ``device``) in place.

  ``batches`` is a ``[K, B, H, W, C]`` stack of raw batches (uint8 or
  float32 in [0, 1], the global batch of each step; on the host, pinned
  for an asynchronous upload, or on the device); step k preprocesses
  ``batches[k]`` from ``generator``, takes this rank's rows of it
  (``parallel/mesh.py::shard_batch`` under ``mesh``) and trains on them,
  as ``make_train_step`` does: the window is K eager steps, each step's
  preprocess inside it. ``draws`` (K ``draw`` callables, tests) replace
  the step's draws; ``scalars`` (``[K, 4]``, :func:`window_scalars` of the
  state, host or device) are made here when not given.

  ``multi_step.width`` is ``config.tpu.steps_per_dispatch``, K;
  ``multi_step.route`` is :func:`window_route` of ``device``, K and the
  process group (``parallel.ddp.backend``, its world size), fixed here.
  On route 'graph' the window is a CUDA graph (one per width; the static
  inputs take each window by one copy of ``batches`` and one of
  ``scalars``); the state takes no DDP wrapper there (``state.replica``
  None; in a group, ``state.mesh``): DDP keeps the parameters' gradient
  accumulators, bound to the stream it was made on, and a captured
  backward that reaches one bound to another stream breaks the capture.
  ``multi_step.replays``,
  ``multi_step.capture_launches`` and ``multi_step.capture_collectives``
  give, per width, the graph's replays, the kernel launches its capture
  recorded (``ops.launch_totals``) and the collectives it recorded
  (``parallel.spatial.calls``: the mesh's, the gradients' all-reduce,
  the balanced loss's ratio): a replay makes those without counting
  them."""
  train_step = make_train_step(config, sde)
  preprocess = make_preprocess_fn(config)
  parts = config.optim.num_micro_batch * (
      2 if config.training.get("mixed", False) else 1)
  per_window = max(int(config.get("tpu", {}).get("steps_per_dispatch", 1)
                       or 1), 1)
  device_type = torch.device(device).type
  route = window_route(device_type, per_window, ddp_backend(),
                       dist.get_world_size() if dist.is_initialized() else 1)
  graphs: Dict[int, tuple] = {}
  static = {}

  def steps(state, batches, generator, draws, scalars):
    losses = []
    for k in range(batches.shape[0]):
      x = preprocess(batches[k], generator)
      if mesh is not None:
        x = shard_batch(x, mesh, True, parts)
      losses.append(train_step(state, x, generator,
                               draws[k] if draws else None, scalars[k]))
    return torch.stack(losses)

  def multi_step(state: TrainState, batches: torch.Tensor,
                 generator: torch.Generator,
                 draws: Optional[Sequence[Draw]] = None,
                 scalars=None) -> torch.Tensor:
    width = batches.shape[0]
    device = state.optimizer.params[0].device
    if device.type != device_type:
      raise ValueError(f"a window made for {device_type} given a state on "
                       f"{device}")
    if scalars is None:
      scalars = torch.from_numpy(window_scalars(state, width))
    if route == "eager":
      return steps(state, batches.to(device, non_blocking=True), generator,
                   draws, scalars.to(device, non_blocking=True))
    if draws is not None:
      raise ValueError("a captured window draws from its generator: "
                       "draws= is for eager windows")
    if state.replica is not None:
      raise ValueError("a captured window trains without the DDP wrapper: "
                       "give its ranks state.mesh (run_lib._train)")
    if not static:
      k = max(width, per_window)
      static["batches"] = torch.empty((k,) + tuple(batches.shape[1:]),
                                      dtype=batches.dtype, device=device)
      static["scalars"] = torch.empty((k, 4), device=device)
    static["batches"][:width].copy_(batches, non_blocking=True)
    static["scalars"][:width].copy_(scalars, non_blocking=True)
    if width not in graphs:
      graphs[width] = _capture(state, generator, width)
    graph, out = graphs[width]
    graph.replay()
    multi_step.replays[width] += 1
    state.step += width
    state.optimizer.count += width
    return out.clone()

  def _capture(state, generator, width):
    """Capture ``steps`` of ``width`` on the static inputs; before the
    first capture, one step on a side stream (the lazy set-up a capture
    may not do: cuBLAS and cuDNN handles, the kernels' libraries and
    plans), then the state, the step counts and the generator put back."""
    batches = static["batches"][:width]
    table = static["scalars"][:width]
    if not graphs:
      saved = _snapshot(state, generator)
      side = torch.cuda.Stream()
      side.wait_stream(torch.cuda.current_stream())
      with torch.cuda.stream(side):
        steps(state, batches[:1], generator, None, table[:1])
      torch.cuda.current_stream().wait_stream(side)
      _restore(state, generator, saved)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    counts = (state.step, state.optimizer.count)
    before = launch_totals()
    issued = collections.Counter(spatial.calls)
    pool = next(iter(graphs.values()))[0].pool() if graphs else None
    with torch.cuda.graph(graph, pool=pool):
      out = steps(state, batches, generator, None, table)
    state.step, state.optimizer.count = counts
    multi_step.capture_launches[width] = {
        k: v - before[k] for k, v in launch_totals().items()
        if v != before[k]}
    multi_step.capture_collectives[width] = dict(spatial.calls - issued)
    multi_step.replays[width] = 0
    return graph, out

  multi_step.width = per_window
  multi_step.route = route
  multi_step.replays = {}
  multi_step.capture_launches = {}
  multi_step.capture_collectives = {}
  return multi_step


def _snapshot(state: TrainState, generator: torch.Generator) -> dict:
  """Copies of everything a train step changes."""
  opt = state.optimizer
  return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
          "ema": {k: v.clone() for k, v in state.ema.items()},
          "moments": [t.clone() for t in opt.mu + opt.nu + opt.nu_max],
          "counts": (state.step, opt.count),
          "generator": generator.get_state()}


@torch.no_grad()
def _restore(state: TrainState, generator: torch.Generator,
             saved: dict) -> None:
  opt = state.optimizer
  for k, v in state.model.state_dict().items():
    v.copy_(saved["model"][k])
  for k, v in state.ema.items():
    v.copy_(saved["ema"][k])
  for t, v in zip(opt.mu + opt.nu + opt.nu_max, saved["moments"]):
    t.copy_(v)
  for p in opt.params:
    p.grad = None
  state.step, opt.count = saved["counts"]
  generator.set_state(saved["generator"])


def _average_gradients(params, ranks: int) -> None:
  """Each parameter's gradient averaged over the world, in one
  all-reduce."""
  grads = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in params]
  flat = torch.cat([g.reshape(-1) for g in grads])
  spatial.calls["gradients"] += 1
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
