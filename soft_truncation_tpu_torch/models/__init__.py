"""Score networks of the PyTorch port."""

from . import ncsnpp  # noqa: F401  (registers 'ncsnpp')
from .registry import create_model, get_model, register_model

__all__ = ["create_model", "get_model", "register_model"]
