"""Carry weights from the JAX package into the port.

``load_params_npz`` reads the path-keyed npz that
``soft_truncation_tpu/serve/export.py::save_params_npz`` writes (also the
``.params.npz`` of ``tools/export_sampler.py``) back into the nested Flax
parameter tree, with numpy only. ``from_jax_params`` maps that tree onto
the port's state_dict by path: the port's modules carry the Flax names, so
``down_0_0/conv0/kernel`` becomes ``down_0_0.conv0.weight``.
``to_jax_params`` and ``save_params_npz`` go the other way: a port
state_dict to the Flax tree and the npz the JAX package's
``load_params_npz`` reads, bfloat16 and fp8 leaves as same-width unsigned
integers named in its ``__dtypes__`` manifest.
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


# leaves that keep their name, by their number of dimensions: InstanceNorm++
# and VarianceNorm's affine vectors, LogSNR's scalar endpoints
_KEPT = {"alpha": 1, "gamma": 1, "beta": 1, "gamma_min": 0, "gamma_gap": 0}
# the ``batch_stats`` collection's running statistics -> torch's buffers
_STATS = {"mean": "running_mean", "var": "running_var"}


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """Map a Flax parameter tree (nested dict of arrays) to a state_dict.

  conv ``kernel`` HWIO -> ``weight`` OIHW; Dense (and PosDense) ``kernel``
  (in, out) -> ``weight`` (out, in); GroupNorm ``scale`` -> ``weight``;
  ``embed/embedding`` -> ``embed.weight`` (the same rows); ``bias``, the
  Fourier embedding's ``W``, the norms' ``alpha`` / ``gamma`` / ``beta``
  and LogSNR's ``gamma_min`` / ``gamma_gap`` keep their names. The
  ``batch_stats`` collection's tree maps the same way, its ``mean`` /
  ``var`` onto ``running_mean`` / ``running_var``. A leaf of any other kind
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
    elif name == "embedding" and a.ndim == 2 and mods[-1:] == ["embed"]:
      name = "weight"
    elif name in _STATS and a.ndim == 1:
      name = _STATS[name]
    elif _KEPT.get(name) == a.ndim:
      pass
    elif name not in ("bias", "W"):
      raise ValueError(f"no port parameter for leaf {'/'.join(path)} "
                       f"of shape {a.shape}")
    sd[".".join(mods + [name])] = torch.tensor(a)
  return sd


_JAX_NAMES = {"running_mean": "mean", "running_var": "var"}
# torch dtypes that npz cannot hold, by the ml_dtypes name JAX's loader
# resolves, and the unsigned integer of their width
_EXTENDED = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
             torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.uint8),
             torch.float8_e5m2: ("float8_e5m2", torch.int8, np.uint8)}


def to_jax_params(state_dict: Dict[str, torch.Tensor],
                  collection: str = "params") -> Dict[str, Any]:
  """The inverse of :func:`from_jax_params`: a port state_dict as the Flax
  tree of ``collection`` ('params', or 'batch_stats' for the running
  statistics), leaves as CPU tensors in their own dtype. OIHW conv weights
  become HWIO ``kernel``, (out, in) dense weights (in, out) ``kernel``,
  ``embed.weight`` ``embed/embedding``, other 1-D weights GroupNorm
  ``scale``; a leaf of any other kind raises."""
  tree: Dict[str, Any] = {}
  for key, t in state_dict.items():
    *mods, name = key.split(".")
    a = t.detach().cpu()
    stats = name in _JAX_NAMES and a.ndim == 1
    if stats != (collection == "batch_stats"):
      continue
    if stats:
      name = _JAX_NAMES[name]
    elif name == "weight" and a.ndim == 4:
      a, name = a.permute(2, 3, 1, 0), "kernel"
    elif name == "weight" and a.ndim == 2 and mods[-1:] == ["embed"]:
      name = "embedding"
    elif name == "weight" and a.ndim == 2:
      a, name = a.t(), "kernel"
    elif name == "weight" and a.ndim == 1:
      name = "scale"
    elif not (name in ("bias", "W") or _KEPT.get(name) == a.ndim):
      raise ValueError(f"no Flax leaf for {key} of shape {tuple(a.shape)}")
    node = tree
    for m in mods:
      node = node.setdefault(m, {})
    node[name] = a.contiguous()
  return tree


def save_params_npz(tree: Dict[str, Any], path: str) -> None:
  """Write a nested parameter tree (tensors or numpy arrays) as the JAX
  package's ``save_params_npz`` does: path-keyed leaves ('/'-joined), and
  bfloat16 / fp8 leaves bit-cast to unsigned integers and named in the
  ``__dtypes__`` manifest (JSON bytes)."""
  flat, ext_dtypes = {}, {}
  for keys, leaf in _flatten(tree):
    name = "/".join(keys)
    if name == _DTYPES_KEY:
      raise ValueError(f"parameter path collides with the reserved "
                       f"manifest key {_DTYPES_KEY!r}")
    if isinstance(leaf, torch.Tensor):
      leaf = leaf.detach().cpu().contiguous()
      if leaf.dtype in _EXTENDED:
        ext_dtypes[name], signed, unsigned = _EXTENDED[leaf.dtype]
        leaf = leaf.view(signed).numpy().view(unsigned)
      else:
        leaf = leaf.numpy()
    flat[name] = np.asarray(leaf)
  flat[_DTYPES_KEY] = np.frombuffer(
      json.dumps(ext_dtypes, sort_keys=True).encode("utf-8"), np.uint8)
  np.savez(path, **flat)
