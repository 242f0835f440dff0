"""Data helpers of the PyTorch port (the serving slice needs the scaler)."""

from .datasets import get_data_inverse_scaler

__all__ = ["get_data_inverse_scaler"]
