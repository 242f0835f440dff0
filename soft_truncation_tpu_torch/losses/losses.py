"""Training losses and the optimizer.

Counterpart of ``soft_truncation_tpu/losses/losses.py``:

- :class:`Optimizer`: the JAX package's optax chain, in order: clip by the
  global norm (``g * max_norm / norm`` when ``norm >= max_norm``, no epsilon),
  Adam (b2 0.999, or AMSGrad) or AdamW (b2 0.99), decoupled weight decay,
  then the learning rate ``lr * min(count / warmup, 1)`` at the
  pre-increment count, so the first update has learning rate 0 (with
  warmup > 0) while Adam's moments still move. Plain tensor code; the
  parameters are updated in place on themselves under ``torch.no_grad()``,
  which bumps their ``_version`` (``DDPMConv.weight_hwio`` keys its cached
  transpose by it). The step's scalars (the learning rate and both bias
  corrections) are a device tensor the host computes from the count
  (:meth:`Optimizer.scalars`), so that a CUDA graph of steps reads each
  step's values rather than holding the captured ones. The first moment
  is stored in ``config.tpu.adam_mu_dtype`` (:class:`Optimizer`).
- :func:`get_sde_loss_fn`: the continuous score-matching loss with the
  importance-sampling, likelihood (g^2) and default weightings and the
  reconstruction term with both decoders; per-example losses [B].
- :func:`get_smld_loss_fn` / :func:`get_ddpm_loss_fn`: the discrete
  (``training.continuous=False``) SMLD loss of a VE SDE, over the flipped
  (descending) sigma grid, and DDPM loss of a VP SDE; per-example losses.

Random draws go through ``draw(kind, shape, high=None)`` (kind 'uniform',
'normal', 'rademacher', or 'label': integers in [0, high)), in the order
JAX's keys make them: t's uniforms, z, then the reconstruction's z; for the
discrete losses the labels, then the noise. :func:`make_draw` makes one
from a ``torch.Generator``; tests hand in the numbers JAX draws.

Under a space axis (``parallel/spatial.py``) a batch holds this rank's rows
of each image: every sum or mean over a sample's pixels is summed over the
axis and the pixel count is the whole image's, so each per-example loss is
the whole image's, the same on every rank of the axis.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import tpu_dtype
from ..models.score import get_model_fn, get_score_fn
from ..parallel import spatial
from ..sde.core import SDE, VESDE, VPSDE, batch_mul

Draw = Callable[..., torch.Tensor]


def make_draw(generator: torch.Generator, device) -> Draw:
  """``draw(kind, shape, high=None)``: uniforms, standard normals,
  Rademacher signs (+-1 in f32) or integer labels in [0, ``high``) (int64)
  from ``generator`` on ``device``."""

  def draw(kind: str, shape, high: Optional[int] = None) -> torch.Tensor:
    if kind == "label":
      return torch.randint(0, high, shape, generator=generator,
                           device=device)
    if kind == "uniform":
      return torch.rand(shape, generator=generator, device=device)
    if kind == "normal":
      return torch.randn(shape, generator=generator, device=device)
    if kind == "rademacher":
      bits = torch.randint(0, 2, shape, generator=generator, device=device)
      return bits.float() * 2.0 - 1.0
    raise ValueError(f"unknown draw {kind!r}")

  return draw


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def lr_schedule(config) -> Callable[[int], float]:
  """Linear warmup to optim.lr over optim.warmup steps, then constant."""
  lr, warmup = config.optim.lr, config.optim.warmup

  def schedule(count: int) -> float:
    if warmup <= 0:
      return lr
    return lr * min(count / warmup, 1.0)

  return schedule


class Optimizer:
  """Clip -> Adam/AMSGrad/AdamW -> weight decay -> lr, over ``params`` (the
  model's parameters that require a gradient), updating them in place.

  ``config.tpu.adam_mu_dtype`` = 'bfloat16' stores the first moment ``mu``
  in bf16, as optax 0.2.6's ``scale_by_adam(mu_dtype=...)``: the step's
  moment is ``(1 - b1) g + b1 mu`` in f32, its second term the product of
  the stored bf16 ``mu`` with b1 in bf16 (JAX's weakly typed scalar takes
  ``mu``'s dtype), the update reads that f32 moment, and only the stored
  copy is rounded to bf16, last. ``nu`` (and AMSGrad's max) stay f32."""

  def __init__(self, config, params: List[torch.nn.Parameter]):
    o = config.optim
    if o.optimizer not in ("Adam", "AdamW"):
      raise NotImplementedError(f"Optimizer {o.optimizer} not supported yet!")
    self.params = list(params)
    self.b1, self.eps = o.beta1, o.eps
    self.b2 = 0.999 if o.optimizer == "Adam" else 0.99
    self.amsgrad = o.optimizer == "Adam" and o.get("amsgrad", False)
    self.weight_decay = o.weight_decay
    self.grad_clip = o.grad_clip
    self.schedule = lr_schedule(config)
    self.count = 0
    self.mu_dtype = getattr(torch, tpu_dtype(config, "adam_mu_dtype"))
    self.mu = [torch.zeros_like(p, dtype=self.mu_dtype) for p in self.params]
    self.nu = [torch.zeros_like(p) for p in self.params]
    self.nu_max = ([torch.zeros_like(p) for p in self.params]
                   if self.amsgrad else [])

  def scalars(self, count: int) -> np.ndarray:
    """The step's scalars at ``count`` (the pre-increment count), as f32:
    the learning rate ``schedule(count)`` and the bias corrections
    ``1 - b1^(count + 1)`` and ``1 - b2^(count + 1)``, each taken in
    Python floats and rounded once."""
    return np.array([self.schedule(count), 1.0 - self.b1 ** (count + 1),
                     1.0 - self.b2 ** (count + 1)], np.float32)

  @torch.no_grad()
  def step(self, grads: Optional[List[torch.Tensor]] = None,
           scalars: Optional[torch.Tensor] = None) -> None:
    """One update from ``grads`` (default: each parameter's ``.grad``);
    ``scalars`` is :meth:`scalars` of the count on the parameters' device
    (default: made here from ``count``)."""
    if grads is None:
      grads = [p.grad for p in self.params]
    if scalars is None:
      scalars = torch.from_numpy(self.scalars(self.count)).to(
          grads[0].device)
    lr, bc1, bc2 = scalars.unbind()
    if self.grad_clip >= 0:
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
      scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                          self.grad_clip / norm)
      grads = torch._foreach_mul(grads, scale)
    if self.mu_dtype == torch.float32:
      mu = self.mu
      torch._foreach_mul_(mu, self.b1)
      torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
    else:
      b1 = torch.full((), self.b1, dtype=self.mu_dtype,
                      device=grads[0].device)
      mu = torch._foreach_mul(grads, 1.0 - self.b1)
      torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1))
    torch._foreach_mul_(self.nu, self.b2)
    torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
    mu_hat = torch._foreach_div(mu, bc1)
    nu_hat = torch._foreach_div(self.nu, bc2)
    if self.amsgrad:
      torch._foreach_maximum_(self.nu_max, nu_hat)
      nu_hat = self.nu_max
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, self.eps)
    updates = torch._foreach_div(mu_hat, denom)
    if self.weight_decay:
      torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
    # optax's order: the updates scaled by -lr, then added
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(self.params, updates)
    if mu is not self.mu:
      torch._foreach_copy_(self.mu, mu)  # rounded to mu_dtype
    self.count += 1

  def state_dict(self) -> Dict:
    return {"count": self.count, "mu": self.mu, "nu": self.nu,
            "nu_max": self.nu_max}

  @torch.no_grad()
  def load_state_dict(self, sd: Dict) -> None:
    self.count = int(sd["count"])
    for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"]),
                         (self.nu_max, sd["nu_max"])):
      if len(mine) != len(theirs):
        raise ValueError(f"optimizer state holds {len(theirs)} tensors, "
                         f"this model {len(mine)}")
      for dst, src in zip(mine, theirs):
        dst.copy_(src)


def get_optimizer(config, model: torch.nn.Module) -> Optimizer:
  """The optimizer over ``model``'s trainable parameters (the frozen
  Fourier ``W`` is not one of them)."""
  return Optimizer(config, [p for p in model.parameters() if p.requires_grad])


# ---------------------------------------------------------------------------
# Discretized Gaussian decoder
# ---------------------------------------------------------------------------


def _approx_standard_normal_cdf(x):
  return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                 * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
  """log P(x | N(means, exp(log_scales))) for 8-bit data scaled to [-1, 1]."""
  if x.shape != means.shape:
    raise ValueError(f"x {tuple(x.shape)} and means {tuple(means.shape)}")
  centered = x - means
  inv_stdv = torch.exp(-log_scales)
  cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
  cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
  log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
  log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
  cdf_delta = cdf_plus - cdf_min
  return torch.where(
      x < -0.999, log_cdf_plus,
      torch.where(x > 0.999, log_one_minus_cdf_min,
                  torch.log(torch.clamp(cdf_delta, min=1e-12))))


# ---------------------------------------------------------------------------
# Continuous score-matching loss
# ---------------------------------------------------------------------------


def _image_sum(x: torch.Tensor) -> torch.Tensor:
  """[B, n] -> [B]: each sample's sum over its pixels, under a space axis
  over every rank's rows (``parallel/spatial.py``)."""
  space = spatial.current()
  if space is None:
    return torch.sum(x, dim=-1)
  return space.sum(torch.sum(x, dim=-1))


def _image_mean(x: torch.Tensor) -> torch.Tensor:
  """[B, n] -> [B]: each sample's mean over its pixels, as
  :func:`_image_sum`."""
  space = spatial.current()
  if space is None:
    return torch.mean(x, dim=-1)
  return space.sum(torch.sum(x, dim=-1)) / (x.shape[-1] * space.size)


def _reduce_op(config):
  """The per-example reduction: the mean over the pixels, or half their
  sum (``training.reduce_mean``)."""
  if config.training.reduce_mean:
    return _image_mean
  return lambda x: 0.5 * _image_sum(x)


def get_sde_loss_fn(config, sde: SDE, train: bool,
                    variance: str = "scoreflow") -> Callable:
  """Returns ``loss_fn(model, batch, t_min, importance_sampling, draw,
  generator=None)`` -> per-example losses [B]; ``generator`` feeds the
  network's dropout at train."""
  if variance not in ("ddpm", "scoreflow"):
    raise ValueError(variance)
  reduce_mean = config.training.reduce_mean
  likelihood_weighting = config.training.likelihood_weighting
  reconstruction_loss = config.training.reconstruction_loss
  dequantization = config.data.dequantization
  reduce_op = _reduce_op(config)

  def loss_fn(model, batch: torch.Tensor, t_min: torch.Tensor,
              importance_sampling: bool, draw: Draw,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    b = batch.shape[0]
    t, Z = sde.sample_diffusion_time(draw("uniform", (b,)), t_min,
                                     importance_sampling)
    score_fn = get_score_fn(config, sde, model, train=train,
                            continuous=True, generator=generator)
    z = draw("normal", tuple(batch.shape))
    mean, std = sde.marginal_prob(batch, t)
    perturbed = mean + batch_mul(std, z)
    score = score_fn(perturbed, t)

    if not importance_sampling and likelihood_weighting:
      g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
      sq = torch.square(score + batch_mul(1.0 / std, z))
      losses = 0.5 * Z * reduce_op(sq.reshape(b, -1)) * g2
    else:
      sq = torch.square(batch_mul(std, score) + z)
      losses = 0.5 * Z * reduce_op(sq.reshape(b, -1))

    if reconstruction_loss:
      eps_vec = t_min.expand(b)
      r_mean, r_std = sde.marginal_prob(batch, eps_vec)
      rz = draw("normal", tuple(batch.shape))
      r_perturbed = r_mean + batch_mul(r_std, rz)
      r_score = score_fn(r_perturbed, eps_vec)

      alpha, beta = sde.marginal_prob(torch.ones_like(batch), eps_vec)
      q_mean = r_perturbed / alpha + batch_mul(beta ** 2, r_score) / alpha
      if variance == "ddpm":
        q_std = beta
      else:
        q_std = beta / _image_mean(alpha.reshape(b, -1))

      # the whole image's size, under a space axis too
      space = spatial.current()
      n_dim = math.prod(batch.shape[1:]) * (space.size if space else 1)

      if dequantization == "lossless":
        decoder_nll = -discretized_gaussian_log_likelihood(
            batch, means=q_mean, log_scales=torch.log(q_std).reshape(b, 1, 1,
                                                                     1))
        recon = _image_sum(decoder_nll.reshape(b, -1))
      else:
        p_entropy = n_dim / 2.0 * (math.log(2 * math.pi)
                                   + 2 * torch.log(r_std) + 1.0)
        q_recon = (n_dim / 2.0 * (math.log(2 * math.pi)
                                  + 2 * torch.log(q_std))
                   + 0.5 / (q_std ** 2)
                   * _image_sum(torch.square(batch - q_mean).reshape(b, -1)))
        recon = q_recon - p_entropy
      if reduce_mean:
        recon = recon / n_dim
      losses = losses + recon

    return losses

  return loss_fn


# ---------------------------------------------------------------------------
# Discrete SMLD / DDPM losses
# ---------------------------------------------------------------------------


def get_smld_loss_fn(config, vesde: VESDE, train: bool) -> Callable:
  """Returns ``loss_fn(model, batch, draw, generator=None)`` -> the
  per-example SMLD (NCSN) losses: a label per example, uniform over the N
  noise levels of the flipped (descending) grid, the batch perturbed by
  that sigma, and the squared error to -noise / sigma^2 weighted by
  sigma^2. The network takes the integer labels."""
  if not isinstance(vesde, VESDE):
    raise ValueError("SMLD training only works for VESDEs.")
  reduce_op = _reduce_op(config)

  def loss_fn(model, batch: torch.Tensor, draw: Draw,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    b = batch.shape[0]
    smld_sigmas = torch.flip(vesde.discrete_sigmas(batch.device), (0,))
    labels = draw("label", (b,), vesde.N)
    sigmas = smld_sigmas[labels]
    noise = batch_mul(sigmas, draw("normal", tuple(batch.shape)))
    score = get_model_fn(model, train=train, generator=generator)(
        batch + noise, labels)
    target = -batch_mul(1.0 / sigmas ** 2, noise)
    sq = torch.square(score - target)
    return reduce_op(sq.reshape(b, -1)) * sigmas ** 2

  return loss_fn


def get_ddpm_loss_fn(config, vpsde: VPSDE, train: bool) -> Callable:
  """Returns ``loss_fn(model, batch, draw, generator=None)`` -> the
  per-example DDPM losses: a label per example, uniform over the N steps,
  the batch noised with that step's sqrt(alpha-bar), and the squared error
  of the network's output to the noise."""
  if not isinstance(vpsde, VPSDE):
    raise ValueError("DDPM training only works for VPSDEs.")
  reduce_op = _reduce_op(config)

  def loss_fn(model, batch: torch.Tensor, draw: Draw,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    b = batch.shape[0]
    labels = draw("label", (b,), vpsde.N)
    sqrt_ac = vpsde.sqrt_alphas_cumprod(batch.device)
    sqrt_1m = vpsde.sqrt_1m_alphas_cumprod(batch.device)
    noise = draw("normal", tuple(batch.shape))
    perturbed = (batch_mul(sqrt_ac[labels], batch)
                 + batch_mul(sqrt_1m[labels], noise))
    score = get_model_fn(model, train=train, generator=generator)(
        perturbed, labels)
    sq = torch.square(score - noise)
    return reduce_op(sq.reshape(b, -1))

  return loss_fn
