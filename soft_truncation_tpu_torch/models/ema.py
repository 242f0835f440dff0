"""Exponential moving average of the parameters.

Counterpart of ``soft_truncation_tpu/models/ema.py``: one step
``e <- e - (1 - d) (e - p)`` with the warmup decay
``d = min(decay, (1 + n) / (10 + n))`` at the post-increment step ``n``,
taken in f32 as JAX takes it. The shadow is a dict of copies keyed like the
model's ``state_dict`` (the frozen Fourier ``W`` included, never moved); it
is updated in place. The JAX package's ``config.tpu.ema_dtype`` (a bf16
shadow, a TPU byte diet) is not read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_init(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
  """A copy (not an alias) of every tensor of ``model.state_dict()``."""
  return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float, num_updates: int) -> None:
  """One EMA step of ``ema`` towards ``model``'s trainable parameters."""
  d = np.minimum(np.float32(decay),
                 np.float32(1.0 + num_updates) / np.float32(10.0 + num_updates))
  names, params = zip(*((n, p) for n, p in model.named_parameters()
                        if p.requires_grad))
  shadow = [ema[n] for n in names]
  diff = torch._foreach_sub(shadow, list(params))
  torch._foreach_mul_(diff, float(np.float32(1.0) - d))
  torch._foreach_sub_(shadow, diff)
