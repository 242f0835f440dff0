"""Training of the PyTorch port: state, step and checkpoints."""

from .checkpoint import CheckpointManager
from .state import TrainState, init_train_state
from .step import (make_eval_loss_step, make_multi_train_step,
                   make_train_step, window_route, window_scalars)

__all__ = ["CheckpointManager", "TrainState", "init_train_state",
           "make_eval_loss_step", "make_multi_train_step", "make_train_step",
           "window_route", "window_scalars"]
