"""Carry weights from the JAX package into the port.

``load_params_npz`` reads the path-keyed npz that
``soft_truncation_tpu/serve/export.py::save_params_npz`` writes (also the
``.params.npz`` of ``tools/export_sampler.py``) back into the nested Flax
parameter tree, with numpy only. ``from_jax_params`` maps that tree onto
the port's state_dict by path: the port's modules carry the Flax names, so
``down_0_0/conv0/kernel`` becomes ``down_0_0.conv0.weight``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

_DTYPES_KEY = "__dtypes__"


def _bfloat16_to_float32(bits: np.ndarray) -> np.ndarray:
  return (bits.astype(np.uint32) << 16).view(np.float32)


def load_params_npz(path: str) -> Dict[str, Any]:
  """Rebuild the nested-dict parameter tree from a params npz.

  bfloat16 leaves (stored as uint16 bits) come back as float32; other
  extended dtypes raise."""
  params: Dict[str, Any] = {}
  with np.load(path) as f:
    ext_dtypes = (json.loads(bytes(f[_DTYPES_KEY]).decode("utf-8"))
                  if _DTYPES_KEY in f.files else {})
    for name in f.files:
      if name == _DTYPES_KEY:
        continue
      node = params
      keys = name.split("/")
      for k in keys[:-1]:
        node = node.setdefault(k, {})
      leaf = f[name]
      if name in ext_dtypes:
        if ext_dtypes[name] != "bfloat16":
          raise ValueError(f"{name}: dtype {ext_dtypes[name]} is not "
                           "supported by the port")
        leaf = _bfloat16_to_float32(leaf)
      node[keys[-1]] = leaf
  return params


def _flatten(tree, prefix=()):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flatten(v, prefix + (k,))
    else:
      yield prefix + (k,), v


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """Map a Flax parameter tree (nested dict of arrays) to a state_dict.

  conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (in, out) ->
  ``weight`` (out, in); GroupNorm ``scale`` -> ``weight``; ``bias`` and the
  Fourier embedding's ``W`` keep their names. A leaf of any other kind
  raises; load the result with ``model.load_state_dict(sd)`` (strict),
  which raises on any port parameter left unset or any leaf without one.
  """
  sd = {}
  for path, leaf in _flatten(tree):
    a = np.asarray(leaf, dtype=np.float32)
    *mods, name = path
    if name == "kernel" and a.ndim == 4:
      a, name = a.transpose(3, 2, 0, 1), "weight"
    elif name == "kernel" and a.ndim == 2:
      a, name = a.T, "weight"
    elif name == "scale" and a.ndim == 1:
      name = "weight"
    elif name not in ("bias", "W"):
      raise ValueError(f"no port parameter for leaf {'/'.join(path)} "
                       f"of shape {a.shape}")
    sd[".".join(mods + [name])] = torch.tensor(a)
  return sd
