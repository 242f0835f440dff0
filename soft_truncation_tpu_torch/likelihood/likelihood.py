"""Exact NLL (probability-flow ODE), single-sample NELBO and the
truncation-boundary residual, in bits per dimension.

Counterpart of ``soft_truncation_tpu/likelihood/likelihood.py``:

- the Hutchinson-Skilling divergence is a forward-mode derivative,
  ``torch.func.jvp`` of the drift (``jax.jvp`` there), whose primal is the
  drift itself: one jvp per ODE function evaluation gives both. On the
  card each fused GroupNorm->SiLU->conv site and each FIR site of the
  network then launches its kernel for the primal and its tangent kernel
  for the tangent (``ops/gn_conv.py``, ``ops/fir.py``);
- the exact NLL integrates the flat ``[x, logp]`` state with the port's
  ``sample/ode.py::odeint_dopri5`` (steered on the host with the same f32
  step control as JAX's);
- the NELBO takes the same jvp with the score as its auxiliary output.

Every SDE's exact NLL; the NELBO of the VP, VE and reciprocal-VE SDEs. The
subVP SDE has no importance sampler, so its NELBO raises, as in JAX.

Random draws go through ``draw(kind, shape)`` (``losses.make_draw`` of a
``torch.Generator``; tests hand in JAX's draws), in the order JAX's keys
make them: the NLL's Hutchinson eps, its z0 ('correct' mode), then the
residual's z; the NELBO's t uniforms, z, eps, the prior term's z, then the
residual's z. Everything runs under ``torch.no_grad()``: the forward-mode
derivative needs no autograd graph.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..losses.losses import Draw, discretized_gaussian_log_likelihood, make_draw
from ..models.score import get_score_fn
from ..sample.ode import odeint_dopri5
from ..sde.core import SDE, ReverseSDE, batch_mul


def _hutchinson_noise(draw: Draw, shape, hutchinson_type: str):
  if hutchinson_type == "Gaussian":
    return draw("normal", shape)
  if hutchinson_type == "Rademacher":
    return draw("rademacher", shape)
  raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")


def get_div_fn(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
  """Hutchinson-Skilling divergence ``eps^T (d fn / dx) eps`` of
  ``x -> fn(x, t)``, per example, by ``torch.func.jvp``."""

  def div_fn(x, t, eps):
    _, jvp_val = torch.func.jvp(lambda xx: fn(xx, t), (x,), (eps,))
    return torch.sum((jvp_val * eps).reshape(x.shape[0], -1), dim=-1)

  return div_fn


def get_ode_fn(config, sde: SDE, model, epsilon: torch.Tensor) -> Callable:
  """``ode_fn(t, flat)`` -> d/dt of the flat ``[x, logp]`` state: the drift
  of the probability-flow ODE (``eval.probability_flow``, ``eval.lambda_``)
  under the eval network and its Hutchinson divergence along ``epsilon``
  (x's shape), both from one ``torch.func.jvp``. ``t`` is a host float."""
  score_fn = get_score_fn(config, sde, model, train=False, continuous=True)
  rsde = ReverseSDE(sde, score_fn,
                    probability_flow=config.eval.probability_flow,
                    lambda_=config.eval.lambda_)
  shape, b, n_flat = epsilon.shape, epsilon.shape[0], epsilon.numel()

  def ode_fn(t, flat):
    x = flat[:n_flat].reshape(shape)
    vec_t = torch.full((b,), float(t), device=flat.device)
    drift, jvp_val = torch.func.jvp(lambda xx: rsde.sde(xx, vec_t)[0], (x,),
                                    (epsilon,))
    logp_grad = torch.sum((jvp_val * epsilon).reshape(b, -1), dim=-1)
    return torch.cat([drift.reshape(-1), logp_grad])

  return ode_fn


def get_likelihood_fn(config, sde: SDE, inverse_scaler,
                      hutchinson_type: str = "Rademacher",
                      rtol: float = 1e-5, atol: float = 1e-5) -> Callable:
  """Returns ``likelihood_fn(model, data, generator=None, logdet=0.,
  eps=1e-5, mode='correct', draw=None)`` -> (bpd [B], z, nfe).

  'correct' starts the ODE at a sample of p_eps(x | data) and subtracts
  the residual (``get_likelihood_residual_fn``, 'scoreflow' variance);
  'wrong' starts it at the data. ``bpd`` carries the ``7 -
  inverse_scaler(-1)`` offset to 8-bit data."""

  @torch.no_grad()
  def likelihood_fn(model, data: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    logdet=0.0, eps: float = 1e-5, mode: str = "correct",
                    draw: Optional[Draw] = None):
    if mode not in ("correct", "wrong"):
      raise NotImplementedError(mode)
    draw = draw or make_draw(generator, data.device)
    shape = tuple(data.shape)
    b, n_flat = shape[0], data.numel()
    epsilon = _hutchinson_noise(draw, shape, hutchinson_type)
    if mode == "correct":
      z0 = draw("normal", shape)
      mean, std = sde.marginal_prob(data, torch.full((b,), eps,
                                                     device=data.device))
      init_x = mean + batch_mul(std, z0)
    else:
      init_x = data
    init = torch.cat([init_x.reshape(-1), data.new_zeros((b,))])
    result = odeint_dopri5(get_ode_fn(config, sde, model, epsilon), init,
                           eps, sde.T, rtol=rtol, atol=atol)
    z = result.y[:n_flat].reshape(shape)
    delta_logp = result.y[n_flat:]
    prior_logp = sde.prior_logp(z)
    if mode == "correct":
      residual_fn = get_likelihood_residual_fn(config, sde, model,
                                               variance="scoreflow")
      delta_logp = delta_logp - residual_fn(data, eps, draw=draw)
    n_dim = math.prod(shape[1:])
    bpd = -(prior_logp + delta_logp + logdet) / math.log(2) / n_dim
    offset = 7.0 - inverse_scaler(-1.0)
    return bpd + offset, z, result.nfe

  return likelihood_fn


def get_elbo_fn(config, sde: SDE, inverse_scaler,
                hutchinson_type: str = "Rademacher") -> Callable:
  """Returns ``loss_fn(model, batch, generator=None, logdet=0., eps=1e-5,
  draw=None)`` -> (NELBO bpd [B], residual bpd [B]): one importance-sampled
  t per example (VP: density ~ beta / sigma^2 and its normaliser Z;
  reciprocal VE: uniform in 1/t, q_t and the ``rve_scale`` below)."""
  is_rve = config.training.sde.lower() == "reciprocal_vesde"

  @torch.no_grad()
  def loss_fn(model, batch: torch.Tensor,
              generator: Optional[torch.Generator] = None, logdet=0.0,
              eps: float = 1e-5, draw: Optional[Draw] = None):
    draw = draw or make_draw(generator, batch.device)
    b = batch.shape[0]
    shape = tuple(batch.shape)
    score_fn = get_score_fn(config, sde, model, train=False, continuous=True)
    time, Z = sde.sample_diffusion_time(
        draw("uniform", (b,)),
        torch.tensor(eps, dtype=torch.float32, device=batch.device), True)
    qt = (1.0 / (1.0 / eps - 1.0 / sde.T)) if is_rve else 1.0 / (sde.T - eps)

    z = draw("normal", shape)
    mean, std = sde.marginal_prob(batch, time)
    perturbed = mean + batch_mul(std, z)

    def mu_fn(x):
      score = score_fn(x, time)
      f, g = sde.sde(x, time)
      mu = batch_mul(std ** 2, score) - batch_mul(std ** 2 / g ** 2, f)
      return mu, score

    epsilon = _hutchinson_noise(draw, shape, hutchinson_type)
    # eps^T (d mu / dx) eps, with the primal's score as the auxiliary output
    _, jvp_val, score = torch.func.jvp(mu_fn, (perturbed,), (epsilon,),
                                       has_aux=True)
    a = batch_mul(std, score)
    Mu = -torch.sum((jvp_val * epsilon).reshape(b, -1), dim=-1) * Z / qt
    Nu = -torch.sum((a ** 2).reshape(b, -1), dim=-1) * Z / 2.0 / qt

    lp_t = torch.full((b,), sde.T, device=batch.device)
    lp_z = draw("normal", shape)
    lp_mean, lp_std = sde.marginal_prob(batch, lp_t)
    lp = sde.prior_logp(lp_mean + batch_mul(lp_std, lp_z))

    rve_scale = (2.0 * eps * math.log(sde.sigma_max / sde.sigma_min)
                 if is_rve else 1.0)
    elbos = lp + (Mu + Nu) * rve_scale
    n_dim = math.prod(shape[1:])
    residual_fn = get_likelihood_residual_fn(config, sde, model,
                                             variance="scoreflow")
    nelbo_bpd = (-(elbos + logdet) / n_dim / math.log(2)
                 + 7.0 - inverse_scaler(-1.0))
    residual_bpd = (residual_fn(batch, eps, draw=draw) / n_dim
                    / math.log(2))
    return nelbo_bpd, residual_bpd

  return loss_fn


def get_likelihood_residual_fn(config, sde: SDE, model,
                               variance: str = "ddpm") -> Callable:
  """``residual_fn(batch, eps=None, generator=None, draw=None)`` -> the
  per-example residual in nats at t = eps (default ``sde.eps``): the
  Gaussian decoder, or the discretized-Gaussian one when
  ``data.dequantization`` is 'lossless'; q's std is beta ('ddpm') or
  beta / mean(alpha) ('scoreflow')."""
  if variance not in ("ddpm", "scoreflow"):
    raise ValueError(variance)
  score_fn = get_score_fn(config, sde, model, train=False, continuous=True)
  lossless = config.data.dequantization == "lossless"
  centered = config.data.centered

  @torch.no_grad()
  def residual_fn(batch: torch.Tensor, eps: Optional[float] = None,
                  generator: Optional[torch.Generator] = None,
                  draw: Optional[Draw] = None) -> torch.Tensor:
    draw = draw or make_draw(generator, batch.device)
    if eps is None:
      eps = sde.eps
    b = batch.shape[0]
    eps_vec = torch.full((b,), eps, device=batch.device)
    mean, std = sde.marginal_prob(batch, eps_vec)
    z = draw("normal", tuple(batch.shape))
    perturbed = mean + batch_mul(std, z)
    score = score_fn(perturbed, eps_vec)

    alpha, beta = sde.marginal_prob(torch.ones_like(batch), eps_vec)
    q_mean = perturbed / alpha + batch_mul(beta ** 2, score) / alpha
    q_std = beta if variance == "ddpm" else beta / alpha.mean(dim=(1, 2, 3))

    n_dim = math.prod(batch.shape[1:])
    p_entropy = n_dim / 2.0 * (math.log(2 * math.pi) + 2 * torch.log(std)
                               + 1.0)
    if lossless:
      x, qm, qs = batch, q_mean, q_std
      if not centered:
        x, qm, qs = 2.0 * x - 1.0, 2.0 * qm - 1.0, 2.0 * qs
      decoder_nll = -discretized_gaussian_log_likelihood(
          x, means=qm, log_scales=torch.log(qs).reshape(b, 1, 1, 1))
      return decoder_nll.sum(dim=(1, 2, 3)) - p_entropy
    q_recon = (n_dim / 2.0 * (math.log(2 * math.pi) + 2 * torch.log(q_std))
               + 0.5 / (q_std ** 2)
               * torch.square(batch - q_mean).sum(dim=(1, 2, 3)))
    return q_recon - p_entropy

  return residual_fn
