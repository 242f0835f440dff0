"""Dropout of the res-blocks: the identity at eval.

Counterpart of ``soft_truncation_tpu/models/dropout.py``. The serving slice
runs the network at eval only; the training forward (and its mask draws)
comes with ROADMAP.md slice 2.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Dropout(nn.Module):

  def __init__(self, rate: float):
    super().__init__()
    self.rate = rate

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    if train:
      raise NotImplementedError(
          "training-mode dropout arrives with ROADMAP.md slice 2 "
          "(ST train step)")
    return x
