"""Samplers of the serving slice: probability-flow ODE and DPM-Solver++(2M).

Counterpart of ``soft_truncation_tpu/sample/sampling.py``. A sampler is
``sampler(model, generator=None, x=None) -> (samples in [0, 1], nfe)``:
the prior is drawn with ``generator`` on the model's device unless ``x``
hands in the starting state. Runs under ``torch.inference_mode``. The PC
sampler comes with ROADMAP.md slice 3, the Picard samplers with slice 6.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.score import get_score_fn
from ..sde.core import SDE, ReverseSDE
from .ode import odeint_dopri5


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
  if name == "pc":
    raise NotImplementedError(
        "sampling.method='pc' arrives with ROADMAP.md slice 3")
  if name in ("picard", "picard_dpm"):
    raise NotImplementedError(
        f"sampling.method={name!r} arrives with ROADMAP.md slice 6")
  raise ValueError(f"Sampler name {config.sampling.method} unknown.")


def _start(sde: SDE, shape, model, generator, x) -> torch.Tensor:
  if x is not None:
    if tuple(x.shape) != tuple(shape):
      raise ValueError(f"x has shape {tuple(x.shape)}, sampler {shape}")
    return x
  device = next(model.parameters()).device
  return sde.prior_sampling(generator, shape, device)


def _denoise_step(sde, score_fn, x, eps, probability_flow=True):
  """Final step to the t=0 mean."""
  rsde = ReverseSDE(sde, score_fn, probability_flow=probability_flow,
                    lambda_=0.0 if probability_flow else 1.0)
  vec_eps = torch.full((x.shape[0],), eps, device=x.device)
  f, _ = rsde.discretize(x, vec_eps, torch.zeros_like(vec_eps))
  return x - f


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


def get_dpm_solver_sampler(config, sde: SDE, shape, inverse_scaler,
                           steps: int = 50, denoise: bool = True,
                           eps: float = 1e-3) -> Callable:
  """DPM-Solver++(2M) in data-prediction form (Lu et al., 2211.01095).

  In log-SNR time, with h_i = lambda_{i+1} - lambda_i:
      x_{i+1} = (s_{i+1}/s_i) x_i - c_{i+1} (e^{-h_i} - 1) D_i
      D_i = (1 + k) x0_i - k x0_{i-1},   k = h_i / (2 h_{i-1})
  (the first step is the order-1 update). One score evaluation per step;
  with ``denoise`` the final state is replaced by its data prediction.
  The step coefficients are host f32 scalars, as the JAX version computes
  them in f32."""
  N = int(steps)

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    score_fn = get_score_fn(config, sde, model, train=False, continuous=True)
    x = _start(sde, shape, model, generator, x)
    ts, c_all, s_all, lam = _dpm_schedule(sde, N, eps)

    def data_pred(x, i):
      t_vec = torch.full((x.shape[0],), ts[i].item(), device=x.device)
      return ((x + (s_all[i] ** 2).item() * score_fn(x, t_vec))
              / c_all[i].item())

    prev_d = torch.zeros_like(x)
    for i in range(N):
      d = data_pred(x, i)
      h = lam[i + 1] - lam[i]
      h_prev = lam[i] - lam[max(i - 1, 0)]
      k = (h / (2.0 * h_prev)).item() if h_prev > 0 else 0.0
      D = (1.0 + k) * d - k * prev_d
      x = ((s_all[i + 1] / s_all[i]).item() * x
           - (c_all[i + 1] * torch.expm1(-h)).item() * D)
      prev_d = d
    nfe = N
    if denoise:
      x = data_pred(x, N)
      nfe += 1
    return inverse_scaler(x), nfe

  return sampler


def get_ode_sampler(config, sde: SDE, shape, inverse_scaler,
                    denoise: bool = False, rtol: float = 1e-5,
                    atol: float = 1e-5, eps: float = 1e-3) -> Callable:
  """Probability-flow ODE sampler on the adaptive dopri5 integrator."""

  @torch.inference_mode()
  def sampler(model, generator: Optional[torch.Generator] = None,
              x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    score_fn = get_score_fn(config, sde, model, train=False, continuous=True)
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
