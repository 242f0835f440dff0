"""Configs of the PyTorch port: the schema and copies of the JAX files."""

from .base import Config, default_config, load_config, override

__all__ = ["Config", "default_config", "load_config", "override"]
