"""Load a reference (score_sde_pytorch-style) checkpoint into the port.

The reference stores NCSN++ and DDPM as a flat ``nn.ModuleList`` walked by
a running index, so their state_dict keys are ``all_modules.<idx>.<param>``;
NCSN and NCSNv2 use named attributes. This module is a copy of the JAX
package's numpy-only mapping (``soft_truncation_tpu/utils/torch_port.py``):
it re-derives the reference's construction order from the config and maps
every tensor onto the Flax-named tree (conv OIHW -> HWIO, linear (out, in)
-> (in, out), NIN ``W`` -> Dense kernel, GroupNorm weight -> scale), which
``utils.jax_params.from_jax_params`` then maps onto the port's state_dict.

:func:`load_reference_checkpoint` composes the two: a reference ``.pth``
({model, ema, optimizer, step}) or a bare state_dict in, the port model's
state_dict out (the EMA shadow's weights with ``ema=True``). This is the
README's "Migrating from the reference" path for the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from .jax_params import from_jax_params


def _conv(sd, prefix):
  out = {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}
  if f"{prefix}.bias" in sd:
    out["bias"] = sd[f"{prefix}.bias"]
  return out


def _linear(sd, prefix):
  return {"kernel": np.transpose(sd[f"{prefix}.weight"]),
          "bias": sd[f"{prefix}.bias"]}


def _nin(sd, prefix):
  return {"kernel": sd[f"{prefix}.W"], "bias": sd[f"{prefix}.b"]}


def _gn(sd, prefix):
  return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _resblock(sd, prefix):
  """Either ResnetBlockBigGANpp or ResnetBlockDDPMpp (same field names,
  except the shortcut: Conv_2 for BigGAN / NIN_0 for DDPM)."""
  out = {
      "norm0": _gn(sd, f"{prefix}.GroupNorm_0"),
      "conv0": _conv(sd, f"{prefix}.Conv_0"),
      "norm1": _gn(sd, f"{prefix}.GroupNorm_1"),
      "conv1": _conv(sd, f"{prefix}.Conv_1"),
  }
  if f"{prefix}.Dense_0.weight" in sd:
    out["temb_proj"] = _linear(sd, f"{prefix}.Dense_0")
  if f"{prefix}.Conv_2.weight" in sd:
    out["shortcut"] = _conv(sd, f"{prefix}.Conv_2")
  elif f"{prefix}.NIN_0.W" in sd:
    out["shortcut"] = _nin(sd, f"{prefix}.NIN_0")
  return out


def _attn(sd, prefix):
  return {
      "norm": _gn(sd, f"{prefix}.GroupNorm_0"),
      "q": _nin(sd, f"{prefix}.NIN_0"),
      "k": _nin(sd, f"{prefix}.NIN_1"),
      "v": _nin(sd, f"{prefix}.NIN_2"),
      "out": _nin(sd, f"{prefix}.NIN_3"),
  }


def _resample(sd, prefix):
  """layerspp.Upsample/Downsample with params: either plain Conv_0 or the
  fused FIR ConvResample Conv2d_0."""
  if f"{prefix}.Conv2d_0.weight" in sd:
    return {"conv": {
        "kernel": np.transpose(sd[f"{prefix}.Conv2d_0.weight"], (2, 3, 1, 0)),
        "bias": sd[f"{prefix}.Conv2d_0.bias"],
    }}
  return {"conv": _conv(sd, f"{prefix}.Conv_0")}


def ncsnpp_module_order(config) -> List[Tuple[str, str]]:
  """(kind, flax_name) for each entry of the reference's all_modules list,
  in construction order (models/ncsnpp.py:74-256)."""
  m = config.model
  L = len(m.ch_mult)
  all_res = [config.data.image_size // (2 ** i) for i in range(L)]
  attn_res = tuple(m.attn_resolutions)
  attention = m.get("attention", True)
  aux = m.get("auxiliary_resblock", True)
  ddpm_block = m.resblock_type.lower() == "ddpm"
  prog = m.progressive.lower()
  prog_in = m.progressive_input.lower()

  order: List[Tuple[str, str]] = []
  if m.embedding_type.lower() == "fourier":
    order.append(("gauss", "fourier_emb"))
  if m.conditional:
    order.append(("linear", "temb_dense0"))
    order.append(("linear", "temb_dense1"))
  if m.get("fourier_feature", False):
    order.append(("none", "fixed_fourier"))
  order.append(("conv", "stem"))

  for i in range(L):
    for b in range(m.num_res_blocks):
      order.append(("res", f"down_{i}_{b}"))
      if all_res[i] in attn_res and attention:
        order.append(("attn", f"down_attn_{i}_{b}"))
    if i != L - 1:
      if ddpm_block:
        order.append(("resample", f"down_{i}_ds"))
      elif aux:
        order.append(("res", f"down_{i}_ds"))
      if prog_in == "input_skip":
        order.append(("combine", f"combine_{i}"))
      elif prog_in == "residual":
        order.append(("resample", f"pyr_ds_{i}"))

  order += [("res", "mid_res0"), ("attn", "mid_attn"), ("res", "mid_res1")]

  n_up = m.num_res_blocks + 1 if aux else m.num_res_blocks
  for i in reversed(range(L)):
    for b in range(n_up):
      order.append(("res", f"up_{i}_{b}"))
    if all_res[i] in attn_res and attention:
      order.append(("attn", f"up_attn_{i}"))
    if prog != "none":
      if i == L - 1 or prog == "output_skip":
        order.append(("gn", f"pyr_norm_{i}"))
        order.append(("conv", f"pyr_conv_{i}"))
      else:  # progressive == 'residual' at lower levels
        order.append(("resample", f"pyr_us_{i}"))
    if i != 0:
      if ddpm_block:
        order.append(("resample", f"up_{i}_us"))
      elif aux:
        order.append(("res", f"up_{i}_us"))

  if prog != "output_skip":
    order.append(("gn", "out_norm"))
    order.append(("conv", "out_conv"))
  return order


def ddpm_module_order(config) -> List[Tuple[str, str]]:
  """(kind, flax_name) per entry of the legacy DDPM's all_modules list,
  in construction order (models/ddpm.py:40-106)."""
  m = config.model
  L = len(m.ch_mult)
  all_res = [config.data.image_size // (2 ** i) for i in range(L)]
  attn_res = tuple(m.attn_resolutions)

  order: List[Tuple[str, str]] = []
  if m.conditional:
    order.append(("linear", "temb_dense0"))
    order.append(("linear", "temb_dense1"))
  order.append(("conv", "stem"))
  for i in range(L):
    for b in range(m.num_res_blocks):
      order.append(("res", f"down_{i}_{b}"))
      if all_res[i] in attn_res:
        order.append(("attn", f"down_attn_{i}_{b}"))
    if i != L - 1:
      order.append(("resample", f"down_{i}_ds"))
  order += [("res", "mid_res0"), ("attn", "mid_attn"), ("res", "mid_res1")]
  for i in reversed(range(L)):
    for b in range(m.num_res_blocks + 1):
      order.append(("res", f"up_{i}_{b}"))
    if all_res[i] in attn_res:
      order.append(("attn", f"up_attn_{i}"))
    if i != 0:
      order.append(("resample", f"up_{i}_us"))
  order += [("gn", "out_norm"), ("conv", "out_conv")]
  return order


def port_ddpm_state_dict(state_dict: Dict[str, np.ndarray],
                         config) -> Dict[str, Any]:
  """torch state_dict -> Flax params for models.ddpm.DDPM.from_config.
  The legacy DDPM reuses the ++ submodule names (GroupNorm_0/Conv_0/...,
  models/layers.py:558-661), so the same converters apply."""
  sd = {k.removeprefix("module."): np.asarray(v)
        for k, v in state_dict.items()}
  params: Dict[str, Any] = {}
  for idx, (kind, name) in enumerate(ddpm_module_order(config)):
    converted = _CONVERTERS[kind](sd, f"all_modules.{idx}")
    if converted is not None:
      params[name] = converted
  return params


_CONVERTERS = {
    "conv": _conv,
    "linear": _linear,
    "res": _resblock,
    "attn": _attn,
    "gn": _gn,
    "resample": _resample,
    "combine": lambda sd, p: {"conv": _conv(sd, f"{p}.Conv_0")},
    "gauss": lambda sd, p: {"W": sd[f"{p}.W"]},
    "none": lambda sd, p: None,
}


_NCSNV2_KEY_RULES = [
    # torch attribute path -> our Flax module path (models/ncsnv2.py,
    # models/refine.py keep the reference's naming modulo these renames)
    (r"res(\d+)\.(\d+)\.", lambda m: f"res{m[1]}_{m[2]}."),
    (r"normalize1\.", lambda m: "norm1."),
    (r"normalize2\.", lambda m: "norm2."),
    (r"adapt_convs\.(\d+)\.", lambda m: f"adapt_{m[1]}."),
    (r"output_convs\.", lambda m: "output."),
    (r"convs\.(\d+)\.", lambda m: f"conv_{m[1]}."),   # MSF/CRP conv lists
    (r"norms\.(\d+)\.", lambda m: f"norm_{m[1]}."),   # cond MSF/CRP norms
    # RCU convs/norms: reference names are 1-indexed '{i}_{j}_conv'
    # (models/layers.py:188-214); ours are 0-indexed 'conv_{i}_{j}'
    (r"(\d+)_(\d+)_conv\.",
     lambda m: f"conv_{int(m[1]) - 1}_{int(m[2]) - 1}."),
    (r"(\d+)_(\d+)_norm\.",
     lambda m: f"norm_{int(m[1]) - 1}_{int(m[2]) - 1}."),
]


def port_ncsnv2_state_dict(state_dict: Dict[str, np.ndarray],
                           config=None) -> Dict[str, Any]:
  """torch state_dict -> Flax params for the NCSNv1/v2 family
  (models/ncsnv2.py:43-416). Unlike NCSN++'s flat ModuleList, these
  models use named attributes, so the port is a systematic key rewrite
  plus layout conversion (conv OIHW->HWIO, Embedding weight->embedding).
  """
  import re

  params: Dict[str, Any] = {}
  for key, value in state_dict.items():
    key = key.removeprefix("module.")
    if key == "sigmas" or ".instance_norm." in key:
      continue  # buffer / param-free torch InstanceNorm2d
    for pat, repl in _NCSNV2_KEY_RULES:
      key = re.sub(pat, repl, key)
    parts = key.split(".")
    leaf, path = parts[-1], parts[:-1]
    value = np.asarray(value)
    if leaf == "weight":
      if value.ndim == 4:  # conv
        leaf, value = "kernel", np.transpose(value, (2, 3, 1, 0))
        path = path + ["Conv_0"]  # NCSNConv wraps one anonymous nn.Conv
      elif path and path[-1] == "embed":  # nn.Embedding -> nn.Embed
        leaf = "embedding"
      else:  # nn.Linear
        leaf, value = "kernel", np.transpose(value)
    elif leaf == "bias":  # all v2-family biases are conv biases
      path = path + ["Conv_0"]
    node = params
    for p in path:
      node = node.setdefault(p, {})
    node[leaf] = value
  return params


def port_ncsnpp_state_dict(state_dict: Dict[str, np.ndarray],
                           config) -> Dict[str, Any]:
  """torch state_dict (numpy values; 'module.'/'all_modules.' keys ok) ->
  Flax params dict for models.ncsnpp.NCSNpp.from_config(config)."""
  sd = {}
  for k, v in state_dict.items():
    k = k.removeprefix("module.")
    sd[k] = np.asarray(v)

  params: Dict[str, Any] = {}
  for idx, (kind, name) in enumerate(ncsnpp_module_order(config)):
    converted = _CONVERTERS[kind](sd, f"all_modules.{idx}")
    if converted is not None:
      params[name] = converted
  return params


_PORTERS = {"ncsnpp": port_ncsnpp_state_dict, "ddpm": port_ddpm_state_dict,
            "ncsn": port_ncsnv2_state_dict,
            "ncsnv2_64": port_ncsnv2_state_dict,
            "ncsnv2_128": port_ncsnv2_state_dict,
            "ncsnv2_256": port_ncsnv2_state_dict}


def _ema_state_dict(model_sd: Dict[str, np.ndarray], shadow, name: str,
                    config) -> Dict[str, np.ndarray]:
  """The model's state_dict with its EMA shadow's values: the shadow is a
  flat list in ``parameters()`` order, i.e. the state_dict's minus the
  ``sigmas`` buffer and the frozen Fourier ``W``."""
  ema_sd = dict(model_sd)
  shadow = [np.asarray(p) for p in shadow]
  si = 0
  for k, v in model_sd.items():
    if k.endswith("sigmas"):
      continue
    if (k.endswith("all_modules.0.W") and name == "ncsnpp"
        and config.model.get("embedding_type") == "fourier"):
      continue
    if si >= len(shadow) or tuple(shadow[si].shape) != tuple(v.shape):
      raise ValueError(f"EMA shadow mismatch at {k}")
    ema_sd[k] = shadow[si]
    si += 1
  if si != len(shadow):
    raise ValueError(f"EMA shadow has {len(shadow)} tensors, the model {si}")
  return ema_sd


def load_reference_checkpoint(
    source: Union[str, Mapping[str, Any]], config,
    ema: bool = False) -> Dict[str, torch.Tensor]:
  """The port model's state_dict (``create_model(config)``) from a
  reference checkpoint: a path to its ``.pth`` ({model, ema, optimizer,
  step}), such a dict, or a bare model state_dict (tensors or arrays;
  ``module.`` prefixes are dropped). With ``ema`` the EMA shadow's weights
  (the checkpoint must hold them). Load the result with
  ``model.load_state_dict(sd)``, which checks that every parameter is
  set."""
  name = config.model.name.lower()
  if name not in _PORTERS:
    raise ValueError(f"no reference mapping for model {config.model.name}")
  ckpt = (torch.load(source, map_location="cpu", weights_only=True)
          if isinstance(source, str) else source)
  model_sd = ckpt["model"] if "model" in ckpt else ckpt
  model_sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                            else v) for k, v in model_sd.items()}
  if ema:
    shadow = (ckpt.get("ema") or {}).get("shadow_params")
    if shadow is None:
      raise ValueError("the checkpoint holds no EMA shadow_params")
    model_sd = _ema_state_dict(
        model_sd, [s.detach().cpu() if isinstance(s, torch.Tensor) else s
                   for s in shadow], name, config)
  return from_jax_params(_PORTERS[name](model_sd, config))
