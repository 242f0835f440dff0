"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
  """``torch.device(device)``, refusing a CUDA device when there is no card.

  Entry points default to 'cuda'; the CPU runs only when asked for."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device is available; pass device='cpu' "
                       "(or --cpu) to run on the host")
  return device
