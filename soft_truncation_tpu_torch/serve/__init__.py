"""Sampling server of the PyTorch port."""

from .server import SamplingService, make_server

__all__ = ["SamplingService", "make_server"]
