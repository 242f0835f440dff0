"""Samplers of the PyTorch port."""

from .ode import odeint_dopri5, odeint_rk4_fixed
from .sampling import get_sampling_fn

__all__ = ["get_sampling_fn", "odeint_dopri5", "odeint_rk4_fixed"]
