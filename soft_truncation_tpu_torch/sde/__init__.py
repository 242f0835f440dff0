"""Diffusion SDEs of the PyTorch port."""

from .core import SDE, VPSDE, ReverseSDE, batch_mul, get_sde

__all__ = ["SDE", "VPSDE", "ReverseSDE", "batch_mul", "get_sde"]
