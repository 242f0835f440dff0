"""Diffusion SDEs of the PyTorch port."""

from .core import (SDE, VESDE, VPSDE, ReciprocalVESDE, ReverseSDE, SubVPSDE,
                   batch_mul, get_sde, st_active_for)

__all__ = ["SDE", "VESDE", "VPSDE", "ReciprocalVESDE", "ReverseSDE",
           "SubVPSDE", "batch_mul", "get_sde", "st_active_for"]
