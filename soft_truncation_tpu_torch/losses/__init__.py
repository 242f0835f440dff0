"""Training losses and the optimizer of the PyTorch port."""

from .losses import (Optimizer, discretized_gaussian_log_likelihood,
                     get_ddpm_loss_fn, get_optimizer, get_sde_loss_fn,
                     get_smld_loss_fn, lr_schedule, make_draw)

__all__ = ["Optimizer", "discretized_gaussian_log_likelihood",
           "get_ddpm_loss_fn", "get_optimizer", "get_sde_loss_fn",
           "get_smld_loss_fn", "lr_schedule", "make_draw"]
