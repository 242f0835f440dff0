"""Config schema for the PyTorch port: a small attribute dict + defaults.

Mirrors ``soft_truncation_tpu/configs/base.py`` without ``ml_collections``:
the same section/key names and values, limited to the keys the serving
slice reads. Config files under ``configs/`` are copies of the JAX
package's files, importing this module instead of the JAX one.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping


class Config(dict):
  """dict with attribute access; nested mappings become ``Config``s."""

  def __init__(self, values: Mapping[str, Any] | None = None):
    super().__init__()
    for k, v in (values or {}).items():
      self[k] = v

  def __setitem__(self, key, value):
    if isinstance(value, Mapping) and not isinstance(value, Config):
      value = Config(value)
    super().__setitem__(key, value)

  def __getattr__(self, key):
    try:
      return self[key]
    except KeyError:
      raise AttributeError(key) from None

  def __setattr__(self, key, value):
    self[key] = value

  def __deepcopy__(self, memo):
    return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


# The values of soft_truncation_tpu/configs/base.py::_CIFAR10 for every key
# the serving slice reads.
_CIFAR10 = dict(
    training=dict(
        continuous=True, unbounded_parametrization=False, ddpm_score=True,
        truncation_time=1e-5, stabilizing_constant=1e-3),
    sampling=dict(
        noise_removal=True, batch_size=1024, truncation_time=1e-5,
        dpm_steps=50),
    data=dict(dataset="CIFAR10", image_size=32, centered=False,
              num_channels=3),
    model=dict(
        sigma_min=0.01, sigma_max=50.0, num_scales=1000, beta_min=0.1,
        beta_max=20.0, dropout=0.1, embedding_type="fourier",
        auxiliary_resblock=True, attention=True, fourier_feature=False,
        lsgm=False),
)

_DEFAULTS = {"cifar10": _CIFAR10}


def default_config(dataset: str = "cifar10") -> Config:
  """The default config of a dataset family (only 'cifar10' is ported)."""
  config = Config(copy.deepcopy(_DEFAULTS[dataset.lower()]))
  config.seed = 42
  return config


def override(config: Config, changes: Dict[str, Any]) -> Config:
  """Apply ``{section: {key: value}}`` overrides in place (new keys allowed)."""
  for section, values in changes.items():
    if isinstance(values, Mapping) and isinstance(config.get(section), Config):
      for k, v in values.items():
        config[section][k] = v
    else:
      config[section] = values
  return config


def load_config(path: str) -> Config:
  """Run a config file's ``get_config()`` (the file imports this module)."""
  import importlib.util
  spec = importlib.util.spec_from_file_location("_st_torch_config", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.get_config()
