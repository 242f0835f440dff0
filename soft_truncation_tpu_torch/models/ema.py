"""Exponential moving average of the parameters.

Counterpart of ``soft_truncation_tpu/models/ema.py``: one step
``e <- e - (1 - d) (e - p)`` with the warmup decay
``d = min(decay, (1 + n) / (10 + n))`` at the post-increment step ``n``,
taken in f32 as JAX takes it. The shadow is a dict of copies keyed like the
model's ``state_dict`` (the frozen Fourier ``W`` included, never moved); it
is updated in place. ``config.tpu.ema_dtype`` = 'bfloat16' stores the
shadow in bf16 (:func:`ema_init`'s ``dtype``); the step still runs in f32
on the upcast shadow and rounds the result once into it, as JAX's
``ema_update`` casts back to the storage dtype. The step's weight
``1 - d`` is a device tensor (:func:`ema_apply`), which the host computes
(:func:`ema_weight`), so that a CUDA graph of train steps reads each
step's weight rather than holding the captured one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_init(model: torch.nn.Module,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
  """A copy (not an alias) of every tensor of ``model.state_dict()``, its
  floating-point tensors in ``dtype``."""
  return {k: v.detach().to(dtype if v.is_floating_point() else v.dtype,
                           copy=True)
          for k, v in model.state_dict().items()}


def ema_weight(decay: float, num_updates: int) -> np.float32:
  """``1 - d`` of the step to ``num_updates``, in f32 as JAX takes it."""
  d = np.minimum(np.float32(decay),
                 np.float32(1.0 + num_updates) / np.float32(10.0 + num_updates))
  return np.float32(1.0) - d


def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float, num_updates: int) -> None:
  """One EMA step of ``ema`` towards ``model``'s trainable parameters."""
  device = next(iter(ema.values())).device
  ema_apply(ema, model, torch.full((), ema_weight(decay, num_updates),
                                   dtype=torch.float32, device=device))


@torch.no_grad()
def ema_apply(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
              weight: torch.Tensor) -> None:
  """One EMA step with the f32 device scalar ``weight`` = ``1 - d``."""
  names, params = zip(*((n, p) for n, p in model.named_parameters()
                        if p.requires_grad))
  stored = [ema[n] for n in names]
  # a reduced-precision shadow: the step on f32 copies, rounded back once
  shadow = [e if e.dtype == torch.float32 else e.float() for e in stored]
  diff = torch._foreach_sub(shadow, list(params))
  torch._foreach_mul_(diff, weight)
  torch._foreach_sub_(shadow, diff)
  for e, s in zip(stored, shadow):
    if e is not s:
      e.copy_(s)
