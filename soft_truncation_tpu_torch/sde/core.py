"""Forward and reverse diffusion SDEs on torch tensors.

Counterpart of ``soft_truncation_tpu/sde/core.py``: the VP, subVP, VE and
reciprocal-VE SDEs, the reverse-time SDE / probability-flow ODE, and
``get_sde``. SDE objects are frozen dataclasses of Python floats; ``x`` is
NHWC ``[B, H, W, C]`` and ``t`` is ``[B]``, on any device. Random draws take
an explicit ``torch.Generator``. The reciprocal VE SDE keeps the JAX
design: its constants and their logs are Python float64, and the device
evaluates ``exp((2/t) * log b)`` in f32. subVP keeps the reference's
marginal "std" without its square root, as the JAX package does.

Training-time samplers: ``sample_diffusion_time`` (uniform or importance
sampled) and the Soft-Truncation prior ``sample_t_min`` map uniforms the
caller drew (from the train step's ``torch.Generator``, or handed in by a
test, the same draws JAX's keys make) to times. ``t_min`` is a 0-d float32
tensor.

Reference behaviour quirk (the JAX package's ``sde/core.py`` docstring):
the released reference samples ``t_min`` only for the VP SDE; the JAX
package and this port apply Soft-Truncation to every SDE when
``training.st`` is set, and ``training.reference_st_quirk = True`` restores
the released behaviour (:func:`st_active_for`).
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

  # --- diffusion-time samplers -------------------------------------------
  def sample_diffusion_time(self, u: Tensor, t_min: Tensor,
                            importance_sampling: bool
                            ) -> Tuple[Tensor, Tensor]:
    """Per-example diffusion times on [t_min, T] from uniforms ``u`` [B].

    Returns (t [B], Z): Z is the importance-sampling normaliser, 1.0 when
    sampling uniformly."""
    if importance_sampling:
      return self._importance_time(u, t_min)
    return u * (self.T - t_min) + t_min, u.new_ones(())

  def _importance_time(self, u: Tensor, t_min: Tensor):
    raise NotImplementedError(
        f"{type(self).__name__} has no importance sampler.")

  def sample_t_min(self, u: Tensor, k: float,
                   truncation_time: float) -> Tensor:
    """Soft-Truncation prior P(t_min) ~ t_min^-k on [eps, T], by inverse
    CDF of the 0-d uniform ``u``; ``truncation_time`` is eps."""
    eps = truncation_time
    if k == 1.0:
      return eps ** (1.0 - u)
    return eps / (1.0 - u * (1.0 - eps ** (k - 1.0))) ** (1.0 / (k - 1.0))


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
    return (self.antiderivative(t_min.new_full((), self.T))
            - self.antiderivative(t_min))

  def _importance_time(self, u, t_min):
    """Importance-sampled t with density ~ beta(t) / sigma(t)^2 (ScoreFlow)."""
    Z = self.normalizing_constant(t_min)
    bd = self.beta_1 - self.beta_0
    t = (-self.beta_0 + torch.sqrt(
        self.beta_0 ** 2
        + 2.0 * bd * torch.log(1.0 + torch.exp(Z * u
                                               + self.antiderivative(t_min))))
         ) / bd
    return t, Z


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
  """sub-VP SDE: dx = -0.5 beta(t) x dt + sqrt(beta(t) (1 - e^{-2 int
  beta})) dw. Its ``marginal_prob`` returns 1 - exp(2 lmc) as the std,
  without the square root, as the reference and the JAX package do; it has
  no importance sampler, and discretizes by Euler-Maruyama."""

  beta_0: float = 0.1
  beta_1: float = 20.0
  eps: float = 1e-5

  def sde(self, x, t):
    beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
    drift = batch_mul(-0.5 * beta_t, x)
    discount = 1.0 - torch.exp(
        -2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t ** 2)
    return drift, torch.sqrt(beta_t * discount)

  def marginal_prob(self, x, t):
    lmc = -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
    mean = batch_mul(torch.exp(lmc), x)
    std = 1.0 - torch.exp(2.0 * lmc)
    return mean, std

  def prior_sampling(self, generator, shape, device):
    return torch.randn(shape, generator=generator, device=device)

  def prior_logp(self, z):
    return _gaussian_logp(z, 1.0)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
  """Variance-exploding SDE: sigma(t) = sigma_min (sigma_max/sigma_min)^t."""

  sigma_min: float = 0.01
  sigma_max: float = 50.0
  eps: float = 1e-5

  @property
  def _log_ratio(self) -> float:
    return math.log(self.sigma_max) - math.log(self.sigma_min)

  def discrete_sigmas(self, device=None) -> Tensor:
    return torch.exp(torch.linspace(math.log(self.sigma_min),
                                    math.log(self.sigma_max), self.N,
                                    dtype=torch.float32, device=device))

  def sigma(self, t):
    return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

  def sde(self, x, t):
    return torch.zeros_like(x), self.sigma(t) * math.sqrt(
        2.0 * self._log_ratio)

  def marginal_prob(self, x, t):
    return x, self.sigma(t)

  def prior_sampling(self, generator, shape, device):
    return torch.randn(shape, generator=generator,
                       device=device) * self.sigma_max

  def prior_logp(self, z):
    return _gaussian_logp(z, self.sigma_max)

  def discretize(self, x, t, next_t=None):
    """SMLD (NCSN) discretization on the sigma grid, or between ``t`` and
    ``next_t`` when it is given."""
    if next_t is None:
      timestep = (t * (self.N - 1) / self.T).long()
      sigmas = self.discrete_sigmas(t.device)
      sigma = sigmas[timestep]
      adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                             sigmas[torch.clamp(timestep - 1, min=0)])
    else:
      sigma = self.sigma(t)
      adjacent = self.sigma(next_t)
    return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent ** 2)

  def antiderivative(self, t):
    return 2.0 * (math.log(self.sigma_min) + t * self._log_ratio)

  def normalizing_constant(self, t_min):
    return (self.antiderivative(t_min.new_full((), self.T))
            - self.antiderivative(t_min))

  def _importance_time(self, u, t_min):
    Z = self.normalizing_constant(t_min)
    return t_min + (Z * u) / (2.0 * self._log_ratio), Z


@dataclasses.dataclass(frozen=True)
class ReciprocalVESDE(SDE):
  """Reciprocal-time VE SDE of UNCSN++:
  sigma(t)^2 = c1 b1^(2/t) + c2 b2^(2/t), constants fixed by (eta,
  sigma_min, sigma_max, eps) in Python float64."""

  sigma_min: float = 0.01
  sigma_max: float = 50.0
  eta: float = 1e-5
  eps: float = 1e-5

  @property
  def base_sigma(self) -> float:  # b1, slightly below 1
    return (self.eta / self.sigma_max) ** (1.0 / (1.0 / self.eps - 1.0))

  @property
  def const(self) -> float:  # c1
    return self.sigma_max ** 2 / self.base_sigma ** 2

  @property
  def base_sigma_2(self) -> float:  # b2, slightly below 1
    return 1.01 ** (-1.0 / (2.0 * (1.0 / self.eps - 1.0)))

  @property
  def const_2(self) -> float:  # c2 (>= 0 when eta <= sigma_min)
    return -(1.01 ** ((1.0 / self.eps) / (1.0 / self.eps - 1.0))) * (
        self.eta ** 2 - self.sigma_min ** 2)

  def sigma(self, t):
    inv2t = 2.0 / t
    return torch.sqrt(
        self.const * torch.exp(inv2t * math.log(self.base_sigma))
        + self.const_2 * torch.exp(inv2t * math.log(self.base_sigma_2)))

  def sde(self, x, t):
    log_b1 = math.log(self.base_sigma)
    log_b2 = math.log(self.base_sigma_2)
    var_rate = ((-2.0 * self.const * log_b1) * torch.exp((2.0 / t) * log_b1)
                / t ** 2
                + 2.0 * self.const_2 * log_b2
                * torch.exp((2.0 / t) * log_b2) / t ** 2)
    return torch.zeros_like(x), torch.sqrt(var_rate)

  def marginal_prob(self, x, t):
    return x, self.sigma(t)

  def prior_sampling(self, generator, shape, device):
    return torch.randn(shape, generator=generator,
                       device=device) * self.sigma_max

  def prior_logp(self, z):
    return _gaussian_logp(z, self.sigma_max)

  def discretize(self, x, t, next_t=None):
    """G = sqrt(sigma(t)^2 - sigma(next_t)^2), each c_i (b_i^{2/t} -
    b_i^{2/nt}) taken as -c_i b_i^{2/t} expm1((2/nt - 2/t) log b_i) so that
    close grid times do not cancel in f32. ``next_t == 0`` means
    sigma(next) = 0."""
    if next_t is None:
      raise ValueError("the reciprocal VE SDE needs an explicit next_t")
    log_b1 = math.log(self.base_sigma)
    log_b2 = math.log(self.base_sigma_2)
    safe_nt = torch.where(next_t > 0.0, next_t, t)  # no inf * 0
    dinv = 2.0 * (1.0 / safe_nt - 1.0 / t)  # >= 0
    d1 = (-self.const * torch.exp((2.0 / t) * log_b1)
          * torch.expm1(dinv * log_b1))
    d2 = (-self.const_2 * torch.exp((2.0 / t) * log_b2)
          * torch.expm1(dinv * log_b2))
    var_diff = torch.where(next_t > 0.0, d1 + d2, self.sigma(t) ** 2)
    return torch.zeros_like(x), torch.sqrt(torch.clamp(var_diff, min=0.0))

  def sample_diffusion_time(self, u, t_min, importance_sampling=False):
    """Uniform in reciprocal time; the importance-sampling flag is ignored,
    as in the reference."""
    time = u * (1.0 / t_min - 1.0 / self.T) + 1.0 / self.T
    return 1.0 / time, u.new_ones(())

  def sample_t_min(self, u, k, truncation_time):
    """The Soft-Truncation prior, uniform in reciprocal time (``k`` is not
    read, as in the reference)."""
    max_ = u * (1.0 / truncation_time - 1.0 / self.T) + 1.0 / self.T
    return 1.0 / max_


def _gaussian_logp(z: Tensor, std: float) -> Tensor:
  n = math.prod(z.shape[1:])
  dims = tuple(range(1, z.dim()))
  return (-n / 2.0 * math.log(2 * math.pi * std ** 2)
          - torch.sum(z ** 2, dim=dims) / (2 * std ** 2))


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
  """Build the SDE named by ``config.training.sde``."""
  name = config.training.sde.lower()
  m = config.model
  if name == "vpsde":
    return VPSDE(beta_0=m.beta_min, beta_1=m.beta_max, N=m.num_scales,
                 eps=config.training.truncation_time)
  if name == "vesde":
    return VESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max,
                 N=m.num_scales)
  if name == "reciprocal_vesde":
    return ReciprocalVESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max,
                           N=m.num_scales, eta=config.training.eta)
  if name == "rve-sde":  # the legacy flat ve/*_uncsn.py configs' spelling
    return ReciprocalVESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max,
                           N=m.num_scales, eta=config.uncsn.eta)
  if name == "subvpsde":
    return SubVPSDE(beta_0=m.beta_min, beta_1=m.beta_max, N=m.num_scales,
                    eps=config.training.truncation_time)
  raise NotImplementedError(f"SDE {config.training.sde} unknown.")


def st_active_for(sde: SDE, config) -> bool:
  """Whether Soft-Truncation ``t_min`` sampling applies for this run: paper
  semantics, or with ``training.reference_st_quirk`` the released
  reference's, where only the VP SDE honours ``training.st``."""
  if not config.training.st:
    return False
  if config.training.get("reference_st_quirk", False):
    return isinstance(sde, VPSDE)
  return True
