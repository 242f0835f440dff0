"""Parallel-in-time (Picard) sampling: ParaDiGMS (Shih et al., "Parallel
Sampling of Diffusion Models", arXiv:2305.16317) on the port's samplers.

Counterpart of ``soft_truncation_tpu/sample/parallel.py``. The sequential
samplers run N network evaluations one after another at the serving batch
B. These hold a window of W chain-step guesses, evaluate all W steps in
one network call at batch W*B, and iterate the window to its fixed point:
with every step's noise frozen, a step is s_{j+1} = s_j + g_j(s_j), and the
sweep

    S'[j+1] = s_in + sum_{i<=j} g_i(S[i])        (a cumsum over the window)

is stationary exactly where S[j+1] = S[j] + g_j(S[j]), the sequential
recursion. Each sweep fixes at least one more position, so ``max_sweeps``
= W (the default, 0) always reaches the sequential trajectory; ``tol = 0``
runs to it, up to the f32 reordering of the prefix sum. For the PC sampler
the state is the sample x; for DPM-Solver++(2M) it is the pair (x,
previous data prediction), which makes its two-step recurrence a one-step
chain (the step is ``sampling.dpm_step``, shared with the sequential
solver).

Convergence: a position has converged when the RMS change of its state
between sweeps is at most ``tol`` times the smaller of its old and new
state RMS, floored at 1 (the data scale; a VE chain's early states are
~sigma_max). The host reads that error once per sweep; a non-finite error
(positions not yet reached may overflow) means not converged.

Noise order: the sequential PC sampler draws, per step, the corrector's
``n_steps`` noises and then the predictor's, from one generator (or the
``draw`` hook). A window draws its steps' noises in exactly that order
when it reaches them, so ``tol = 0`` reproduces the sequential sample from
the same generator; the whole chain's noise is never held at once.

Batch statistics stay per position: the Langevin corrector's step size is
a mean over each position's B samples (``positions=W``), as JAX's ``vmap``
over the window keeps it.

A stochastic PC chain requires ``tol = 0``: there the sweep criterion
bounds each position's residual, not the trajectory's error, and the
endpoint decorrelates from the sequential one. ``get_picard_pc_sampler``
refuses ``tol > 0`` on such a chain unless ``unsafe_tol`` is set.
``sampling.chunk > 0`` runs the PC chain in segments of whole windows, as
the JAX package bounds its dispatches; the blocks, and so the samples, are
the same either way (the DPM sampler does not read it, as in JAX).

nfe is counted as JAX counts it: sweeps x window positions x evaluations
per step, summed over the blocks (plus the final denoising evaluation for
DPM; not for PC, as the sequential PC sampler does not count it).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..sde.core import SDE, ReciprocalVESDE, ReverseSDE
from .sampling import (Draw, _denoise_step, _start, dpm_data_pred, dpm_step,
                       dpm_tables, draws_per_step, get_corrector,
                       get_predictor, score_of)

State = Tuple[torch.Tensor, ...]


def _rms(x: torch.Tensor) -> torch.Tensor:
  """Per-position RMS of a [P, ...] stack."""
  x = x.reshape(x.shape[0], -1)
  return torch.sqrt(torch.mean(x * x, dim=-1))


def _rms_err(new: State, old: State) -> torch.Tensor:
  """The largest per-position RMS change between sweeps, relative to the
  smaller of the old and new state RMS (floored at 1), over the state's
  tensors."""
  errs = [torch.max(_rms(a - b)
                    / torch.clamp(torch.minimum(_rms(a), _rms(b)), min=1.0))
          for a, b in zip(new, old)]
  return torch.max(torch.stack(errs))


def picard_chain(make_block: Callable, s_in: State, start: int, n: int,
                 window: int, tol: float, max_sweeps: int,
                 evals_per_step: int, aux: Optional[torch.Tensor] = None):
  """Run the chain steps ``start .. start + n - 1`` by block-wise Picard
  iteration over windows of ``window`` steps (the last block takes what
  remains).

  ``make_block(i0, w)`` prepares the steps ``i0 .. i0 + w - 1`` (e.g. draws
  their noise) and returns ``step(S) -> (S_next, aux)``, where ``S`` is
  the state as [w, B, ...] stacks and ``aux`` a [w, B, ...] stack of what
  each step also returns (the predictor's x_mean), or None. Returns
  ``(state, aux of the last step, nfe, sweeps)``."""
  W = max(1, min(int(window), n))
  cap = int(max_sweeps) if max_sweeps else W
  s, nfe, sweeps = s_in, 0, 0
  for i0 in range(start, start + n, W):
    w = min(W, start + n - i0)
    step = make_block(i0, w)
    S = tuple(l.unsqueeze(0).expand((w,) + l.shape).clone() for l in s)
    out, err, block_sweeps = s, math.inf, 0
    while (not math.isfinite(err) or err > tol) and block_sweeps < cap:
      S_new, step_aux = step(S)
      csum = tuple(torch.cumsum(a - b, dim=0) for a, b in zip(S_new, S))
      # position 0 is pinned to the block's entry state
      S_next = tuple(torch.cat([o[:1], si[None] + c[:-1]], dim=0)
                     for o, c, si in zip(S, csum, s))
      err = _rms_err(S_next, S).item()
      out = tuple(si + c[-1] for si, c in zip(s, csum))
      if step_aux is not None:
        aux = step_aux[-1]
      S = S_next
      block_sweeps += 1
    s = out
    nfe += block_sweeps * w * evals_per_step
    sweeps += block_sweeps
  return s, aux, nfe, sweeps


def _segments(n: int, window: int, chunk: int):
  """(start, steps) of each segment: the whole chain, or with ``chunk``
  segments of ``chunk`` steps rounded up to whole windows."""
  if not 0 < chunk < n:
    return [(0, n)]
  W = max(1, min(int(window), n))
  seg = max(1, -(-chunk // W)) * W
  return [(s0, min(seg, n - s0)) for s0 in range(0, n, seg)]


def get_picard_pc_sampler(config, sde: SDE, shape, predictor: str,
                          corrector: str, inverse_scaler, snr: float,
                          n_steps: int = 1, probability_flow: bool = False,
                          continuous: bool = False, denoise: bool = True,
                          eps: float = 1e-3, window: int = 16,
                          tol: float = 1e-3, max_sweeps: int = 0,
                          unsafe_tol: bool = False) -> Callable:
  """The PC sampler (``sampling.get_pc_sampler``'s arguments) iterated in
  windows of ``window`` steps. Returns ``sampler(model, generator=None,
  x=None, draw=None) -> (samples in [0, 1], nfe)``, ``nfe`` as measured;
  ``sampler.last_sweeps`` holds the last call's sweeps summed over its
  blocks."""
  stochastic = ((not probability_flow)
                or predictor.lower() == "ancestral_sampling"
                or (corrector.lower() != "none" and n_steps > 0))
  if stochastic and tol > 0 and not unsafe_tol:
    raise ValueError(
        "picard: tol > 0 on a stochastic chain (probability_flow="
        f"{probability_flow}, predictor={predictor!r}, corrector="
        f"{corrector!r}) silently produces decorrelated samples: the "
        "sweep-to-sweep criterion bounds the per-position residual, not "
        "the trajectory error. Set sampling.picard_tol=0 (the exact fixed "
        "point) or opt in with sampling.picard_unsafe_tol=True.")
  predictor_fn = get_predictor(predictor)
  corrector_fn = get_corrector(corrector)
  N = sde.N
  evals_per_step = n_steps + 1
  n_draws = draws_per_step(predictor, corrector, n_steps)
  chunk = int(config.sampling.get("chunk", 0) or 0)
  timesteps = torch.linspace(sde.T, eps, N, dtype=torch.float32)
  next_timesteps = torch.cat([timesteps[1:], torch.zeros(1)])
  rve = isinstance(sde, ReciprocalVESDE)

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None,
              draw: Optional[Draw] = None) -> Tuple[torch.Tensor, int]:
    score_fn = score_of(config, sde, model, continuous)
    rsde = ReverseSDE(sde, score_fn, probability_flow=probability_flow,
                      lambda_=0.0 if probability_flow else 1.0)
    x = _start(sde, shape, model, generator, x)
    if draw is None:
      def draw(like):
        return torch.randn(like.shape, generator=generator,
                           device=like.device, dtype=like.dtype)
    b = x.shape[0]

    def make_block(i0, w):
      # the sequential order: step by step, each step's draws in turn
      noises = [[draw(x) for _ in range(n_draws)] for _ in range(w)]
      stacked = [torch.cat([noises[j][c] for j in range(w)])
                 for c in range(n_draws)]
      t = timesteps[i0:i0 + w].to(x.device).repeat_interleave(b)
      nt = (next_timesteps[i0:i0 + w].to(x.device).repeat_interleave(b)
            if rve else None)

      def step(S):
        flat = S[0].reshape((w * b,) + S[0].shape[2:])
        calls = iter(stacked)

        def frozen(like):
          return next(calls)

        flat, _ = corrector_fn(sde, score_fn, flat, t, frozen, snr, n_steps,
                               positions=w)
        flat, x_mean = predictor_fn(rsde, flat, t, frozen, next_t=nt)
        return (flat.reshape(S[0].shape),), x_mean.reshape(S[0].shape)

      return step

    state, x_mean, nfe, sweeps = (x,), x, 0, 0
    for start, steps in _segments(N, window, chunk):
      state, x_mean, seg_nfe, seg_sweeps = picard_chain(
          make_block, state, start, steps, window, tol, max_sweeps,
          evals_per_step, aux=x_mean)
      nfe += seg_nfe
      sweeps += seg_sweeps
    sampler.last_sweeps = sweeps
    out = _denoise_step(sde, score_fn, x_mean if denoise else state[0],
                        sde.eps, probability_flow=True)
    return inverse_scaler(out), nfe

  sampler.last_sweeps = 0
  return sampler


def get_picard_dpm_sampler(config, sde: SDE, shape, inverse_scaler,
                           steps: int = 50, denoise: bool = True,
                           eps: float = 1e-3, window: int = 0,
                           tol: float = 1e-3,
                           max_sweeps: int = 0) -> Callable:
  """DPM-Solver++(2M) (``sampling.get_dpm_solver_sampler``'s schedule and
  step) iterated over the augmented state (x, previous data prediction) in
  windows of ``window`` steps (0: the whole chain in one block).
  Deterministic: only the prior matters. Returns ``sampler(model,
  generator=None, x=None) -> (samples in [0, 1], nfe)``, with
  ``sampler.last_sweeps`` as for :func:`get_picard_pc_sampler`."""
  N = int(steps)

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    score_fn = score_of(config, sde, model, True)
    x = _start(sde, shape, model, generator, x)
    tables = dpm_tables(sde, N, eps, x.device)

    def make_block(i0, w):
      return lambda S: (dpm_step(score_fn, tables, S, i0), None)

    state, _, nfe, sweeps = picard_chain(
        make_block, (x, torch.zeros_like(x)), 0, N, window or N, tol,
        max_sweeps, 1)
    sampler.last_sweeps = sweeps
    x = state[0]
    if denoise:
      x = dpm_data_pred(score_fn, tables, x[None], N)[0]
      nfe += 1
    return inverse_scaler(x), nfe

  sampler.last_sweeps = 0
  return sampler
