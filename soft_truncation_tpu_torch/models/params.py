"""Schedule tables of the legacy losses and samplers, in float64 numpy.

Counterpart of ``soft_truncation_tpu/models/params.py`` (the reference's
``models/utils.py:51-86``).
"""

from __future__ import annotations

import numpy as np


def get_sigmas(config) -> np.ndarray:
  """Descending geometric SMLD noise levels, ``model.num_scales`` of them
  from ``model.sigma_max`` to ``model.sigma_min``."""
  return np.exp(np.linspace(np.log(config.model.sigma_max),
                            np.log(config.model.sigma_min),
                            config.model.num_scales))


def get_ddpm_params(config) -> dict:
  """The original DDPM's beta / alpha tables over 1000 steps, from
  ``model.beta_min`` / ``beta_max`` divided by ``model.num_scales``."""
  num_diffusion_timesteps = 1000
  beta_start = config.model.beta_min / config.model.num_scales
  beta_end = config.model.beta_max / config.model.num_scales
  betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps,
                      dtype=np.float64)
  alphas = 1.0 - betas
  alphas_cumprod = np.cumprod(alphas, axis=0)
  return {
      "betas": betas,
      "alphas": alphas,
      "alphas_cumprod": alphas_cumprod,
      "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
      "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
      "beta_min": beta_start * (num_diffusion_timesteps - 1),
      "beta_max": beta_end * (num_diffusion_timesteps - 1),
      "num_diffusion_timesteps": num_diffusion_timesteps,
  }
