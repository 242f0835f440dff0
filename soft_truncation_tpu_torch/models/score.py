"""Score-function wrapping: label transforms and output calibration.

Counterpart of ``soft_truncation_tpu/models/score.py`` for the VP SDE:

  continuous: labels = t*999, or, with unbounded parametrization, the
    normalised antiderivative of the log-variance scaled to [0, 999]; with
    ``training.ddpm_score`` the model predicts scaled noise and
    score = -out / std(t).
  discrete: labels = t*(N-1), std from the DDPM alphas grid.

The VE / reciprocal-VE branches come with ROADMAP.md slice 4.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..sde.core import SDE, VPSDE, batch_mul


def get_model_fn(model, train: bool = False) -> Callable:
  """Raw network apply with the train/eval switch."""

  def model_fn(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return model(x, labels, train=train)

  return model_fn


def get_score_fn(config, sde: SDE, model, train: bool = False,
                 continuous: bool = False) -> Callable:
  """Build s(x, t) from the raw network."""
  model_fn = get_model_fn(model, train=train)
  if not isinstance(sde, VPSDE):
    raise NotImplementedError(
        f"score of {type(sde).__name__} arrives with a later ROADMAP.md "
        "slice")
  unbounded = config.training.get("unbounded_parametrization", False)
  stab = config.training.get("stabilizing_constant", 1e-3)
  ddpm_score = config.training.get("ddpm_score", True)

  def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if continuous:
      if unbounded:
        lo = sde.antiderivative(t.new_tensor(1e-5), stab)
        hi = sde.antiderivative(t.new_tensor(sde.T), stab)
        labels = (sde.antiderivative(t, stab) - lo) / (hi - lo) * 999.0
      else:
        labels = t * 999.0
      std = sde.marginal_std(t)
      score = model_fn(x, labels)
    else:
      labels = t * (sde.N - 1)
      score = model_fn(x, labels)
      std = sde.sqrt_1m_alphas_cumprod(t.device)[labels.long()]
    if ddpm_score:
      score = -batch_mul(1.0 / std, score)
    return score

  return score_fn
