"""Two-tier checkpoints with ``torch.save``.

Counterpart of ``soft_truncation_tpu/train/checkpoint.py``, in the same
layout:

  workdir/checkpoints-meta/checkpoint   the rolling preemption checkpoint,
                                        restored at start
  workdir/checkpoints/checkpoint_<n>    numbered snapshots

Each is one file holding :meth:`TrainState.state_dict` (the model's
parameters under the port's Flax-derived names, the optimizer's moments,
the EMA shadow, the step), written to ``<path>.tmp`` and renamed into
place, so a crash mid-write leaves the previous checkpoint whole.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .state import TrainState

log = logging.getLogger(__name__)


def _save(obj, path: str) -> None:
  tmp = path + ".tmp"
  torch.save(obj, tmp)
  os.replace(tmp, path)


def _load(path: str, state: TrainState) -> TrainState:
  device = next(state.model.parameters()).device
  state.load_state_dict(torch.load(path, map_location=device,
                                   weights_only=True))
  return state


class CheckpointManager:

  def __init__(self, workdir: str):
    self.workdir = os.path.abspath(workdir)
    self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
    self.meta_dir = os.path.join(self.workdir, "checkpoints-meta")
    os.makedirs(self.ckpt_dir, exist_ok=True)
    os.makedirs(self.meta_dir, exist_ok=True)

  @property
  def meta_path(self) -> str:
    return os.path.join(self.meta_dir, "checkpoint")

  def save_meta(self, state: TrainState) -> None:
    _save(state.state_dict(), self.meta_path)

  def restore_meta(self, state: TrainState) -> Optional[TrainState]:
    """Load the rolling checkpoint into ``state`` if there is one; else
    None."""
    if not os.path.exists(self.meta_path):
      log.warning("No checkpoint found at %s. Starting fresh.",
                  self.meta_path)
      return None
    _load(self.meta_path, state)
    log.info("%s loaded ...", self.meta_path)
    return state

  def snapshot_path(self, save_step: int) -> str:
    return os.path.join(self.ckpt_dir, f"checkpoint_{save_step}")

  def save_snapshot(self, state: TrainState, save_step: int) -> None:
    _save(state.state_dict(), self.snapshot_path(save_step))

  def restore_snapshot(self, state: TrainState,
                       save_step: int) -> TrainState:
    return _load(self.snapshot_path(save_step), state)
