"""Samplers of the serving slices: Predictor-Corrector, probability-flow
ODE and DPM-Solver++(2M).

Counterpart of ``soft_truncation_tpu/sample/sampling.py``. A sampler is
``sampler(model, generator=None, x=None) -> (samples in [0, 1], nfe)``:
the prior is drawn with ``generator`` on the model's device unless ``x``
hands in the starting state. ``model`` is the network, or an object that
gives the score function itself (:func:`score_of`: the exported program's
replay, ``serve/export.py::ExportedScore``), so that the live server and the
replay run the same loops. The PC sampler also draws its predictor and
corrector noise from ``generator``, through ``draw(like) -> standard
normal of like's shape``, which a caller may replace (``draw=``) to hand
the same noise to two devices. Runs under ``torch.inference_mode``. The
batch means that steer a sampler (dopri5's error norm, the Langevin step
size) are the whole batch's where its rows are split over ranks
(``parallel/mesh.py::batch_sharded``).
``sampling.method`` 'picard' and 'picard_dpm' are the parallel-in-time
versions of 'pc' and 'dpm_solver' (``sample/parallel.py``); the DPM
schedule and step below are shared with the latter.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import batch_mean
from ..sde.core import (SDE, VESDE, VPSDE, ReciprocalVESDE, ReverseSDE,
                        batch_mul)
from .ode import odeint_dopri5

Draw = Callable[[torch.Tensor], torch.Tensor]
_PREDICTORS = {}
_CORRECTORS = {}


def _registrar(registry):
  def register(name):
    def add(fn):
      if name in registry:
        raise ValueError(f"already registered: {name}")
      registry[name] = fn
      return fn
    return add
  return register


register_predictor = _registrar(_PREDICTORS)
register_corrector = _registrar(_CORRECTORS)


def get_predictor(name: str):
  return _PREDICTORS[name.lower()]


def get_corrector(name: str):
  return _CORRECTORS[name.lower()]


# Predictors: predictor(rsde, x, t, draw, next_t=None) -> (x, x_mean)


@register_predictor("euler_maruyama")
def euler_maruyama_predictor(rsde: ReverseSDE, x, t, draw: Draw,
                             next_t=None):
  dt = -1.0 / rsde.N
  z = draw(x)
  drift, diffusion = rsde.sde(x, t)
  x_mean = x + drift * dt
  return x_mean + batch_mul(diffusion, z) * math.sqrt(-dt), x_mean


@register_predictor("reverse_diffusion")
def reverse_diffusion_predictor(rsde: ReverseSDE, x, t, draw: Draw,
                                next_t=None):
  f, G = rsde.discretize(x, t, next_t)
  z = draw(x)
  x_mean = x - f
  return x_mean + batch_mul(G, z), x_mean


@register_predictor("ancestral_sampling")
def ancestral_sampling_predictor(rsde: ReverseSDE, x, t, draw: Draw,
                                 next_t=None):
  """VE and VP only, on their discrete grids."""
  sde, score_fn = rsde.forward, rsde.score_fn
  z = draw(x)
  timestep = (t * (sde.N - 1) / sde.T).long()
  if isinstance(sde, VESDE):
    sigmas = sde.discrete_sigmas(t.device)
    sigma = sigmas[timestep]
    adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                           sigmas[torch.clamp(timestep - 1, min=0)])
    x_mean = x + batch_mul(sigma ** 2 - adjacent ** 2, score_fn(x, t))
    std = torch.sqrt(adjacent ** 2 * (sigma ** 2 - adjacent ** 2)
                     / sigma ** 2)
    return x_mean + batch_mul(std, z), x_mean
  if isinstance(sde, VPSDE):
    beta = sde.discrete_betas(t.device)[timestep]
    x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta),
                       x + batch_mul(beta, score_fn(x, t)))
    return x_mean + batch_mul(torch.sqrt(beta), z), x_mean
  raise NotImplementedError(
      f"SDE class {type(sde).__name__} not yet supported.")


@register_predictor("none")
def none_predictor(rsde, x, t, draw: Draw, next_t=None):
  return x, x


# Correctors: corrector(sde, score_fn, x, t, draw, snr, n_steps,
#   positions=1) -> (x, x_mean). ``x`` stacks ``positions`` batches of
#   equal size (the Picard window's chain steps): a batch statistic is taken
#   per position.


def _corrector_alpha(sde: SDE, t):
  if isinstance(sde, VPSDE):
    return sde.alphas(t.device)[(t * (sde.N - 1) / sde.T).long()]
  return torch.ones_like(t)


def _per_position_mean(v: torch.Tensor, positions: int) -> torch.Tensor:
  """The mean of [P*B] values over each position's B: a 0-d tensor for one
  position, else [P*B] (each position's mean repeated B times)."""
  if positions == 1:
    return batch_mean(v)
  return v.reshape(positions, -1).mean(dim=1).repeat_interleave(
      v.shape[0] // positions)


def _langevin(sde, score_fn, x, t, draw: Draw, n_steps, step_size_fn):
  alpha = _corrector_alpha(sde, t)
  x_mean = x
  for _ in range(n_steps):
    grad = score_fn(x, t)
    noise = draw(x)
    step_size = step_size_fn(grad, noise) * alpha
    x_mean = x + batch_mul(step_size, grad)
    x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
  return x, x_mean


@register_corrector("langevin")
def langevin_corrector(sde, score_fn, x, t, draw: Draw, snr, n_steps,
                       positions: int = 1):
  """Langevin steps sized to a target signal-to-noise ratio ``snr``, from
  the batch's mean gradient and noise norms (per position)."""

  def norm_mean(v):
    return _per_position_mean(
        torch.linalg.norm(v.reshape(v.shape[0], -1), dim=-1), positions)

  def step_size(grad, noise):
    return (snr * norm_mean(noise) / norm_mean(grad)) ** 2 * 2

  return _langevin(sde, score_fn, x, t, draw, n_steps, step_size)


@register_corrector("ald")
def annealed_langevin_corrector(sde, score_fn, x, t, draw: Draw, snr,
                                n_steps, positions: int = 1):
  """The original NCSN annealed Langevin dynamics."""
  std = sde.marginal_prob(x, t)[1]
  return _langevin(sde, score_fn, x, t, draw, n_steps,
                   lambda grad, noise: (snr * std) ** 2 * 2)


@register_corrector("none")
def none_corrector(sde, score_fn, x, t, draw: Draw, snr, n_steps,
                   positions: int = 1):
  return x, x


def draws_per_step(predictor: str, corrector: str, n_steps: int) -> int:
  """The noises one PC step draws: the corrector's ``n_steps`` (none for
  'none'), then the predictor's one (none for 'none')."""
  return ((n_steps if corrector.lower() != "none" else 0)
          + (predictor.lower() != "none"))


def get_sampling_fn(config, sde: SDE, shape, inverse_scaler,
                    eps: float) -> Callable:
  """Dispatch on ``config.sampling.method``. ``shape`` is NHWC."""
  name = config.sampling.method.lower()
  if name == "ode":
    return get_ode_sampler(config, sde, shape, inverse_scaler,
                           denoise=config.sampling.noise_removal, eps=eps)
  if name == "dpm_solver":
    return get_dpm_solver_sampler(
        config, sde, shape, inverse_scaler,
        steps=config.sampling.get("dpm_steps", 50),
        denoise=config.sampling.noise_removal, eps=eps)
  if name == "picard_dpm":
    from .parallel import get_picard_dpm_sampler
    return get_picard_dpm_sampler(
        config, sde, shape, inverse_scaler,
        steps=config.sampling.get("dpm_steps", 50),
        denoise=config.sampling.noise_removal, eps=eps,
        window=config.sampling.get("picard_window", 0),
        tol=config.sampling.get("picard_tol", 1e-2),
        max_sweeps=config.sampling.get("picard_max_sweeps", 0))
  if name in ("pc", "picard"):
    kwargs = dict(
        predictor=config.sampling.predictor,
        corrector=config.sampling.corrector, inverse_scaler=inverse_scaler,
        snr=config.sampling.snr, n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        continuous=config.training.continuous,
        denoise=config.sampling.noise_removal, eps=eps)
    if name == "pc":
      return get_pc_sampler(config, sde, shape, **kwargs)
    from .parallel import get_picard_pc_sampler
    return get_picard_pc_sampler(
        config, sde, shape,
        window=config.sampling.get("picard_window", 64),
        tol=config.sampling.get("picard_tol", 1e-2),
        max_sweeps=config.sampling.get("picard_max_sweeps", 0),
        unsafe_tol=config.sampling.get("picard_unsafe_tol", False), **kwargs)
  raise ValueError(f"Sampler name {config.sampling.method} unknown.")


def score_of(config, sde: SDE, model, continuous: bool) -> Callable:
  """s(x, t) at eval: ``model.score_fn(continuous)`` where ``model`` gives
  its score function itself, else ``models/score.py::get_score_fn`` of the
  network (imported here: a replay that never builds a network does not
  import the model package)."""
  if hasattr(model, "score_fn"):
    return model.score_fn(continuous)
  from ..models.score import get_score_fn
  return get_score_fn(config, sde, model, train=False, continuous=continuous)


def _start(sde: SDE, shape, model, generator, x) -> torch.Tensor:
  if x is not None:
    if tuple(x.shape) != tuple(shape):
      raise ValueError(f"x has shape {tuple(x.shape)}, sampler {shape}")
    return x
  device = (model.device if hasattr(model, "score_fn")
            else next(model.parameters()).device)
  return sde.prior_sampling(generator, shape, device)


def _denoise_step(sde, score_fn, x, eps, probability_flow=True):
  """Final step to the t=0 mean."""
  rsde = ReverseSDE(sde, score_fn, probability_flow=probability_flow,
                    lambda_=0.0 if probability_flow else 1.0)
  vec_eps = torch.full((x.shape[0],), eps, device=x.device)
  f, _ = rsde.discretize(x, vec_eps, torch.zeros_like(vec_eps))
  return x - f


def get_pc_sampler(config, sde: SDE, shape, predictor: str, corrector: str,
                   inverse_scaler, snr: float, n_steps: int = 1,
                   probability_flow: bool = False, continuous: bool = False,
                   denoise: bool = True, eps: float = 1e-3) -> Callable:
  """Predictor-Corrector sampler over N steps from T to ``eps``.

  Each step runs the corrector, then the predictor; the reciprocal VE SDE
  gets the next grid time (0 after the last step) for its discretization.
  A final probability-flow denoising step at ``sde.eps`` maps the last
  ``x_mean`` (``x`` without ``denoise``) to the sample. nfe is
  N * (n_steps + 1), as the JAX package counts it (the denoising
  evaluation not included)."""
  predictor_fn = get_predictor(predictor)
  corrector_fn = get_corrector(corrector)
  N = sde.N
  timesteps = torch.linspace(sde.T, eps, N, dtype=torch.float32).tolist()
  next_timesteps = timesteps[1:] + [0.0]
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
    x_mean = x
    for t, nt in zip(timesteps, next_timesteps):
      t_vec = torch.full((shape[0],), t, device=x.device)
      nt_vec = torch.full((shape[0],), nt, device=x.device) if rve else None
      x, x_mean = corrector_fn(sde, score_fn, x, t_vec, draw, snr, n_steps)
      x, x_mean = predictor_fn(rsde, x, t_vec, draw, next_t=nt_vec)
    x = _denoise_step(sde, score_fn, x_mean if denoise else x, sde.eps,
                      probability_flow=True)
    return inverse_scaler(x), N * (n_steps + 1)

  return sampler


def _interp(x, xp, fp):
  """``jnp.interp`` for increasing ``xp`` (constant beyond the ends)."""
  i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
  df = fp[i] - fp[i - 1]
  dx = xp[i] - xp[i - 1]
  delta = x - xp[i - 1]
  eps = np.spacing(np.finfo(np.float32).eps)
  dx0 = torch.abs(dx) <= eps
  f = torch.where(dx0, fp[i - 1],
                  fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
  f = torch.where(x < xp[0], fp[0], f)
  return torch.where(x > xp[-1], fp[-1], f)


def _dpm_schedule(sde: SDE, N: int, eps: float):
  """Uniform-log-SNR time grid and affine-marginal coefficients (host f32).

  Returns ``(ts, c_all, s_all, lam)``, each [N+1]."""
  def lam_of(t):
    mean, s = sde.marginal_prob(torch.ones(t.shape + (1, 1, 1)), t)
    return torch.log(mean.reshape(t.shape)) - torch.log(s)

  t_fine = torch.linspace(sde.T, eps, 4096)  # lam increasing along axis
  lam_fine = lam_of(t_fine)
  lam_grid = torch.linspace(lam_fine[0].item(), lam_fine[-1].item(), N + 1)
  ts = _interp(lam_grid, lam_fine, t_fine)
  ts[0], ts[-1] = sde.T, eps

  mean, s_all = sde.marginal_prob(torch.ones((N + 1, 1, 1, 1)), ts)
  c_all = mean.reshape(N + 1)
  lam = torch.log(c_all) - torch.log(s_all)
  return ts, c_all, s_all, lam


class DPMTables(NamedTuple):
  """The DPM-Solver++(2M) coefficients of a grid of N steps, on a device:
  per grid time i (N+1) ``ts``, ``s2`` = s(t_i)^2 and ``c`` = c(t_i); per
  step i (N) ``a`` = s_{i+1}/s_i, ``b`` = c_{i+1} expm1(-h_i) and ``k`` =
  h_i / (2 h_{i-1}) (0 at the first step)."""
  ts: torch.Tensor
  s2: torch.Tensor
  c: torch.Tensor
  a: torch.Tensor
  b: torch.Tensor
  k: torch.Tensor


def dpm_tables(sde: SDE, N: int, eps: float, device) -> DPMTables:
  """:func:`_dpm_schedule`'s grid as :class:`DPMTables`, computed in f32 on
  the host and moved to ``device``."""
  ts, c_all, s_all, lam = _dpm_schedule(sde, N, eps)
  h = lam[1:] - lam[:-1]
  h_prev = torch.cat([h.new_zeros(1), h[:-1]])
  k = torch.where(h_prev > 0, h / (2.0 * h_prev), torch.zeros_like(h))
  tables = DPMTables(ts, s_all ** 2, c_all, s_all[1:] / s_all[:-1],
                     c_all[1:] * torch.expm1(-h), k)
  return DPMTables(*(t.to(device) for t in tables))


def _per_position(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """[P] coefficients shaped to multiply a [P, B, ...] stack."""
  return v.reshape((-1,) + (1,) * (like.dim() - 1))


def dpm_data_pred(score_fn, tables: DPMTables, x: torch.Tensor,
                  i0: int) -> torch.Tensor:
  """The data prediction (x + s^2 score) / c of a [P, B, ...] stack whose
  position p sits at grid time ``i0 + p``: one network call at batch P*B."""
  p, b = x.shape[:2]
  t = tables.ts[i0:i0 + p].repeat_interleave(b)
  score = score_fn(x.reshape((p * b,) + x.shape[2:]), t).reshape(x.shape)
  return ((x + _per_position(tables.s2[i0:i0 + p], x) * score)
          / _per_position(tables.c[i0:i0 + p], x))


def dpm_step(score_fn, tables: DPMTables, state, i0: int):
  """DPM-Solver++(2M) steps ``i0 .. i0 + P - 1`` of the augmented state
  (x, previous data prediction), each a [P, B, ...] stack:

      x_{i+1} = (s_{i+1}/s_i) x_i - c_{i+1} (e^{-h_i} - 1) D_i
      D_i = (1 + k_i) x0_i - k_i x0_{i-1}

  Returns the next state. The sequential sampler runs it at P = 1."""
  x, prev_d = state
  p = x.shape[0]
  d = dpm_data_pred(score_fn, tables, x, i0)
  k = _per_position(tables.k[i0:i0 + p], x)
  big_d = (1.0 + k) * d - k * prev_d
  x = (_per_position(tables.a[i0:i0 + p], x) * x
       - _per_position(tables.b[i0:i0 + p], x) * big_d)
  return x, d


def get_dpm_solver_sampler(config, sde: SDE, shape, inverse_scaler,
                           steps: int = 50, denoise: bool = True,
                           eps: float = 1e-3) -> Callable:
  """DPM-Solver++(2M) in data-prediction form (Lu et al., 2211.01095), in
  log-SNR time with h_i = lambda_{i+1} - lambda_i (:func:`dpm_step`; the
  first step is the order-1 update). One score evaluation per step; with
  ``denoise`` the final state is replaced by its data prediction. The
  step coefficients are f32, as the JAX version computes them."""
  N = int(steps)

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    score_fn = score_of(config, sde, model, True)
    x = _start(sde, shape, model, generator, x)
    tables = dpm_tables(sde, N, eps, x.device)
    state = (x[None], torch.zeros_like(x[None]))
    for i in range(N):
      state = dpm_step(score_fn, tables, state, i)
    x = state[0]
    nfe = N
    if denoise:
      x = dpm_data_pred(score_fn, tables, x, N)
      nfe += 1
    return inverse_scaler(x[0]), nfe

  return sampler


def get_ode_sampler(config, sde: SDE, shape, inverse_scaler,
                    denoise: bool = False, rtol: float = 1e-5,
                    atol: float = 1e-5, eps: float = 1e-3) -> Callable:
  """Probability-flow ODE sampler on the adaptive dopri5 integrator."""

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    score_fn = score_of(config, sde, model, True)
    rsde = ReverseSDE(sde, score_fn, probability_flow=True, lambda_=0.0)
    x = _start(sde, shape, model, generator, x)

    def ode_func(t, flat):
      vec_t = torch.full((shape[0],), float(t), device=flat.device)
      return rsde.sde(flat.reshape(shape), vec_t)[0].reshape(-1)

    result = odeint_dopri5(ode_func, x.reshape(-1), sde.T, eps,
                           rtol=rtol, atol=atol)
    x = result.y.reshape(shape)
    if denoise:
      x = _denoise_step(sde, score_fn, x, sde.eps, probability_flow=False)
    return inverse_scaler(x), result.nfe

  return sampler
