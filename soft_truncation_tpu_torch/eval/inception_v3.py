"""InceptionV3 (the pytorch-FID variant) for FID and IS features, NCHW.

Counterpart of ``soft_truncation_tpu/eval/inception_v3.py``, with its Flax
module names (``Mixed_5b.branch1x1.conv.weight`` for
``Mixed_5b/branch1x1/conv/kernel``, ``Mixed_5b.branch1x1.bn_scale``, ...):

  * every conv has no bias and is followed by a frozen BatchNorm,
    ``(x - mean) * rsqrt(var + 1e-3) * scale + bias``, and a ReLU;
  * the pool branches of InceptionA, C and Mixed_7b average 3x3 windows
    without counting the padding; Mixed_7c's pool branch takes the max;
  * the input, [N, 3, H, W] in [0, 255], is mapped to [-1, 1];
  * the features are the global mean of the last block (pool3, 2048-d),
    the second output the softmax of ``fc`` of them.

Weights load from the flat npz of ``tools/convert_inception_weights.py``
(:func:`load_params_npz`; :func:`save_params_npz` writes it), or are drawn
at random (:func:`random_params`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Flax's lecun_normal: a normal truncated at two standard deviations, scaled
# to unit variance by this constant
_TRUNCATED_STD = 0.87962566103423978


class BasicConv2d(nn.Module):
  """conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU."""

  def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
               padding=0):
    super().__init__()
    self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False)
    for name, fill in (("bn_scale", 1.0), ("bn_bias", 0.0), ("bn_mean", 0.0),
                       ("bn_var", 1.0)):
      self.register_buffer(name, torch.full((out_ch,), fill))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.conv(x)
    x = ((x - self.bn_mean[:, None, None])
         * torch.rsqrt(self.bn_var + 1e-3)[:, None, None]
         * self.bn_scale[:, None, None] + self.bn_bias[:, None, None])
    return F.relu(x)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
  """3x3 stride-1 average over the window's pixels inside the image."""
  return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
  """3x3 stride-2 max pool without padding."""
  return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):

  def __init__(self, in_ch: int, pool_features: int):
    super().__init__()
    self.branch1x1 = BasicConv2d(in_ch, 64, 1)
    self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
    self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
    self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
    self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

  def forward(self, x):
    b5 = self.branch5x5_2(self.branch5x5_1(x))
    b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([self.branch1x1(x), b5, b3,
                      self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):

  def __init__(self, in_ch: int):
    super().__init__()
    self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
    self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

  def forward(self, x):
    bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):

  def __init__(self, in_ch: int, c7: int):
    super().__init__()
    self.branch1x1 = BasicConv2d(in_ch, 192, 1)
    self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
    self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
    self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
    self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
    self.branch_pool = BasicConv2d(in_ch, 192, 1)

  def forward(self, x):
    b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
    bd = self.branch7x7dbl_1(x)
    for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                 self.branch7x7dbl_4, self.branch7x7dbl_5):
      bd = conv(bd)
    return torch.cat([self.branch1x1(x), b7, bd,
                      self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):

  def __init__(self, in_ch: int):
    super().__init__()
    self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
    self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
    self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
    self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
    self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
    self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

  def forward(self, x):
    b7 = self.branch7x7x3_1(x)
    for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
      b7 = conv(b7)
    return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                      _max_pool(x)], 1)


class InceptionE(nn.Module):
  """Mixed_7b pools by the average (``pool='avg'``), Mixed_7c by the max."""

  def __init__(self, in_ch: int, pool: str):
    super().__init__()
    self.pool = pool
    self.branch1x1 = BasicConv2d(in_ch, 320, 1)
    self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
    self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
    self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
    self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch_pool = BasicConv2d(in_ch, 192, 1)

  def forward(self, x):
    b3 = self.branch3x3_1(x)
    b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
    bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
    bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
    bp = (_avg_pool(x) if self.pool == "avg"
          else F.max_pool2d(x, 3, 1, 1))
    return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
  """[N, 3, H, W] in [0, 255] (H, W >= 75) -> (pool3 features [N, 2048],
  class probabilities [N, num_classes])."""

  def __init__(self, num_classes: int = 1000):
    super().__init__()
    self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
    self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
    self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
    self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
    self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
    self.Mixed_5b = InceptionA(192, 32)
    self.Mixed_5c = InceptionA(256, 64)
    self.Mixed_5d = InceptionA(288, 64)
    self.Mixed_6a = InceptionB(288)
    self.Mixed_6b = InceptionC(768, 128)
    self.Mixed_6c = InceptionC(768, 160)
    self.Mixed_6d = InceptionC(768, 160)
    self.Mixed_6e = InceptionC(768, 192)
    self.Mixed_7a = InceptionD(768)
    self.Mixed_7b = InceptionE(1280, "avg")
    self.Mixed_7c = InceptionE(2048, "max")
    self.fc = nn.Linear(2048, num_classes)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x / 127.5 - 1.0
    x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
    x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
    x = _max_pool(x)
    for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                  self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
      x = block(x)
    feats = x.mean(dim=(2, 3))
    return feats, torch.softmax(self.fc(feats), dim=-1)


def _port_name(flax_key: str) -> str:
  """'Mixed_5b/branch1x1/conv/kernel' -> 'Mixed_5b.branch1x1.conv.weight'."""
  *mods, leaf = flax_key.split("/")
  return ".".join(mods + [{"kernel": "weight"}.get(leaf, leaf)])


def _flax_name(port_key: str) -> str:
  *mods, leaf = port_key.split(".")
  return "/".join(mods + [{"weight": "kernel"}.get(leaf, leaf)])


def _from_flax(a: np.ndarray) -> torch.Tensor:
  """A Flax kernel in the port's layout: conv HWIO -> OIHW, Dense (in, out)
  -> (out, in); other arrays as they are."""
  a = np.asarray(a, dtype=np.float32)
  if a.ndim == 4:
    a = a.transpose(3, 2, 0, 1)
  elif a.ndim == 2:
    a = a.T
  return torch.from_numpy(np.ascontiguousarray(a))


def load_params_npz(path: str) -> InceptionV3:
  """An InceptionV3 on the CPU with the weights of a flat npz
  ('Mixed_5b/branch1x1/conv/kernel', ..., 'fc/kernel', 'fc/bias'), with
  as many classes as ``fc/kernel`` has. A key the network does not have,
  or a weight of the network the npz lacks, raises ``KeyError``."""
  with np.load(path) as flat:
    state = {_port_name(k): _from_flax(flat[k]) for k in flat.files}
  if "fc.weight" not in state:
    raise KeyError(f"{path} has no fc/kernel")
  with torch.device("meta"):  # no initialisation: every tensor is loaded
    model = InceptionV3(num_classes=state["fc.weight"].shape[0])
  want = set(model.state_dict())
  unknown, missing = sorted(set(state) - want), sorted(want - set(state))
  if unknown or missing:
    raise KeyError(f"{path}: keys the network does not have "
                   f"{[_flax_name(k) for k in unknown]}, weights missing "
                   f"{[_flax_name(k) for k in missing]}")
  model.load_state_dict(state, assign=True)
  return model.eval()


def save_params_npz(params: Union[nn.Module, Dict[str, torch.Tensor]],
                    path: str) -> None:
  """Write an InceptionV3 (or its state_dict) as the flat npz that
  :func:`load_params_npz` and the JAX package's loader read."""
  if isinstance(params, nn.Module):
    params = params.state_dict()
  flat = {}
  for key, t in params.items():
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
      a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 2:
      a = a.T
    flat[_flax_name(key)] = np.ascontiguousarray(a, dtype=np.float32)
  np.savez(path, **flat)


def random_params(seed: int = 0, gain: float = math.sqrt(2.0),
                  num_classes: int = 1000) -> Dict[str, torch.Tensor]:
  """Random weights of the distribution ``tools/make_random_inception_npz.py``
  draws through Flax, from a ``torch.Generator`` seeded with ``seed``:
  conv and Dense kernels from Flax's lecun_normal (a normal truncated at
  two standard deviations, variance 1 / fan_in), the conv kernels times
  ``gain``; BatchNorm scale 1, bias 0, mean 0, var 1; fc bias 0. The draws
  differ from Flax's; the distribution is the same."""
  gen = torch.Generator().manual_seed(seed)
  with torch.device("meta"):
    shapes = {k: t.shape for k, t in
              InceptionV3(num_classes=num_classes).state_dict().items()}
  state = {}
  for key, shape in shapes.items():
    if key.endswith(".weight"):
      fan_in = math.prod(shape[1:])  # I * kh * kw, or the Dense's inputs
      std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
      t = nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                generator=gen)
      state[key] = t.mul_(std * (gain if len(shape) == 4 else 1.0))
    else:  # BatchNorm's scale and var 1, its bias and mean and fc's bias 0
      state[key] = torch.full(shape, 1.0 if key.endswith(
          ("bn_scale", "bn_var")) else 0.0)
  return state
