"""Score networks of the PyTorch port."""

from . import ncsnpp  # noqa: F401  (registers 'ncsnpp')
from . import ddpm, ncsnv2  # noqa: F401  (the legacy networks)
from .params import get_ddpm_params, get_sigmas
from .registry import create_model, get_model, register_model

__all__ = ["create_model", "get_ddpm_params", "get_model", "get_sigmas",
           "register_model"]
