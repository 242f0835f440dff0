"""Training state: the step, the model, the optimizer and the EMA shadow.

Counterpart of ``soft_truncation_tpu/train/state.py``. Where JAX threads an
immutable pytree through the jitted step, the port's step updates this
object in place (the model's parameters, the optimizer's moments and the
EMA copies), which saves a second copy of each. ``replica`` is the
DistributedDataParallel wrapper of ``model`` under data parallelism
(``parallel.ddp.replicate``; not part of the checkpoint).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..losses.losses import Optimizer, get_optimizer
from ..models.ema import ema_init


@dataclasses.dataclass
class TrainState:
  step: int
  model: torch.nn.Module
  optimizer: Optimizer
  ema: Dict[str, torch.Tensor]
  ema_rate: float = 0.9999
  replica: Optional[torch.nn.Module] = None

  def state_dict(self) -> Dict[str, Any]:
    return {"step": self.step, "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(), "ema": self.ema,
            "ema_rate": self.ema_rate}

  @torch.no_grad()
  def load_state_dict(self, sd: Dict[str, Any]) -> None:
    """Copy a :meth:`state_dict` into this state's tensors in place."""
    self.model.load_state_dict(sd["model"])
    self.optimizer.load_state_dict(sd["optimizer"])
    if set(sd["ema"]) != set(self.ema):
      raise ValueError("the EMA shadow's keys differ from this model's")
    for k, v in sd["ema"].items():
      self.ema[k].copy_(v)
    self.step = int(sd["step"])
    self.ema_rate = float(sd["ema_rate"])


def init_train_state(config, model: torch.nn.Module) -> TrainState:
  """Step 0, a fresh optimizer over ``model`` and an EMA copy of it."""
  return TrainState(step=0, model=model,
                    optimizer=get_optimizer(config, model),
                    ema=ema_init(model), ema_rate=float(config.model.ema_rate))


def param_count(model: torch.nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())
