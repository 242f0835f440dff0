"""Model registry and construction."""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.device import resolve_device

_MODELS: Dict[str, type] = {}


def register_model(cls=None, *, name: str | None = None):
  """Class decorator registering a score network under ``name``."""

  def _register(c):
    local_name = name or c.__name__
    if local_name in _MODELS:
      raise ValueError(f"already registered model with name: {local_name}")
    _MODELS[local_name] = c
    return c

  return _register if cls is None else _register(cls)


def get_model(name: str) -> type:
  return _MODELS[name]


def create_model(config, device="cuda", seed: int = 0) -> torch.nn.Module:
  """The network named by ``config.model.name``, in eval mode on ``device``.

  Weights are drawn on the host from a ``torch.Generator`` seeded with
  ``seed`` (the same weights on every device), then moved. ``device`` is
  'cuda' unless the caller asks for 'cpu'; without a card 'cuda' raises.
  """
  device = resolve_device(device)
  model = get_model(config.model.name).from_config(config)
  model.reset_parameters(torch.Generator().manual_seed(seed))
  return model.eval().to(device)
