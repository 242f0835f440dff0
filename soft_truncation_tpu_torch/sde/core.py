"""Forward and reverse diffusion SDEs on torch tensors.

Counterpart of ``soft_truncation_tpu/sde/core.py`` for the serving slice:
the VP SDE, the reverse-time SDE / probability-flow ODE, and ``get_sde``.
SDE objects are frozen dataclasses of Python floats; ``x`` is NHWC
``[B, H, W, C]`` and ``t`` is ``[B]``, on any device. Random draws take an
explicit ``torch.Generator``. The other SDEs (subVP, VE, reciprocal VE) and
the training-time samplers come with later ROADMAP.md slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


def batch_mul(scale: Tensor, x: Tensor) -> Tensor:
  """Multiply per-example scalars ``scale`` ([B]) into ``x`` ([B, ...])."""
  return x * scale.reshape(scale.shape + (1,) * (x.dim() - scale.dim()))


@dataclasses.dataclass(frozen=True)
class SDE:
  """Base diffusion SDE. All concrete SDEs run on time interval (0, T]."""

  N: int = 1000

  @property
  def T(self) -> float:
    return 1.0

  def sde(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    raise NotImplementedError

  def marginal_prob(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    raise NotImplementedError

  def prior_sampling(self, generator: torch.Generator, shape,
                     device) -> Tensor:
    raise NotImplementedError

  def marginal_std(self, t: Tensor) -> Tensor:
    """std of p_t(x | x_0), shape [B]."""
    return self.marginal_prob(t.new_zeros(t.shape + (1, 1, 1)), t)[1]

  def discretize(self, x: Tensor, t: Tensor,
                 next_t: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Euler-Maruyama default: x_{i+1} = x_i + f + G z."""
    dt = 1.0 / self.N
    drift, diffusion = self.sde(x, t)
    return drift * dt, diffusion * math.sqrt(dt)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
  """Variance-preserving SDE: dx = -0.5 beta(t) x dt + sqrt(beta(t)) dw."""

  beta_0: float = 0.1
  beta_1: float = 20.0
  eps: float = 1e-5  # truncation_time

  def _beta(self, t):
    return self.beta_0 + t * (self.beta_1 - self.beta_0)

  def discrete_betas(self, device=None) -> Tensor:
    return torch.linspace(self.beta_0 / self.N, self.beta_1 / self.N, self.N,
                          dtype=torch.float32, device=device)

  def alphas(self, device=None) -> Tensor:
    return 1.0 - self.discrete_betas(device)

  def sqrt_alphas_cumprod(self, device=None) -> Tensor:
    return torch.sqrt(torch.cumprod(self.alphas(device), dim=0))

  def sqrt_1m_alphas_cumprod(self, device=None) -> Tensor:
    return torch.sqrt(1.0 - torch.cumprod(self.alphas(device), dim=0))

  def sde(self, x, t):
    beta_t = self._beta(t)
    return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t)

  def _log_mean_coeff(self, t):
    return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

  def marginal_prob(self, x, t):
    lmc = self._log_mean_coeff(t)
    mean = batch_mul(torch.exp(lmc), x)
    std = torch.sqrt(1.0 - torch.exp(2.0 * lmc))
    return mean, std

  def prior_sampling(self, generator, shape, device):
    return torch.randn(shape, generator=generator, device=device)

  def prior_logp(self, z):
    n = math.prod(z.shape[1:])
    dims = tuple(range(1, z.dim()))
    return -n / 2.0 * math.log(2 * math.pi) - torch.sum(z ** 2, dim=dims) / 2.0

  def discretize(self, x, t, next_t=None):
    """DDPM discretization, or its continuous form when ``next_t`` is given."""
    if next_t is None:
      timestep = (t * (self.N - 1) / self.T).long()
      beta = self.discrete_betas(t.device)[timestep]
      alpha = self.alphas(t.device)[timestep]
      f = batch_mul(torch.sqrt(alpha), x) - x
      return f, torch.sqrt(beta)
    G = torch.sqrt((t - next_t) * self._beta(t))
    f = batch_mul(torch.sqrt(1.0 - G ** 2), x) - x
    return f, G

  def integral_beta(self, t):
    return 0.5 * t ** 2 * (self.beta_1 - self.beta_0) + t * self.beta_0

  def antiderivative(self, t, stabilizing_constant=0.0):
    ib = self.integral_beta(t)
    return torch.log(1.0 - torch.exp(-ib) + stabilizing_constant) + ib

  def normalizing_constant(self, t_min):
    return (self.antiderivative(torch.as_tensor(self.T, dtype=torch.float32))
            - self.antiderivative(t_min))


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
  """Reverse-time SDE dx = [f - g^2 * score * w] dt + lambda g dw.

  lambda interpolates SDE (1) -> probability-flow ODE (0); the drift weight
  is 0.5 (1 + lambda^2)."""

  forward: SDE
  score_fn: Callable[[Tensor, Tensor], Tensor]
  probability_flow: bool = False
  lambda_: float = 1.0

  def __post_init__(self):
    if self.probability_flow and self.lambda_ != 0.0:
      raise ValueError("probability_flow=True requires lambda_=0 "
                       f"(got lambda_={self.lambda_})")

  @property
  def weight(self) -> float:
    return 0.5 if self.probability_flow else 0.5 * (1.0 + self.lambda_ ** 2)

  @property
  def N(self) -> int:
    return self.forward.N

  @property
  def T(self) -> float:
    return self.forward.T

  def sde(self, x, t):
    drift, diffusion = self.forward.sde(x, t)
    score = self.score_fn(x, t)
    drift = drift - batch_mul(diffusion ** 2, score) * self.weight
    return drift, self.lambda_ * diffusion

  def discretize(self, x, t, next_t=None):
    f, G = self.forward.discretize(x, t, next_t)
    rev_f = f - batch_mul(G ** 2, self.score_fn(x, t)) * self.weight
    return rev_f, self.lambda_ * G


def get_sde(config) -> SDE:
  """Build the SDE named by ``config.training.sde`` (VP only here)."""
  name = config.training.sde.lower()
  if name == "vpsde":
    return VPSDE(beta_0=config.model.beta_min, beta_1=config.model.beta_max,
                 N=config.model.num_scales,
                 eps=config.training.truncation_time)
  if name in ("subvpsde", "vesde", "reciprocal_vesde", "rve-sde"):
    raise NotImplementedError(
        f"SDE {config.training.sde} arrives with a later ROADMAP.md slice "
        "(VE / reciprocal VE with slice 4, subVP with slice 6)")
  raise NotImplementedError(f"SDE {config.training.sde} unknown.")
