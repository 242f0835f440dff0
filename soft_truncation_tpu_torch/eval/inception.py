"""Feature extraction for FID, KID and IS: the extractors and their resizes.

Counterpart of ``soft_truncation_tpu/eval/inception.py``. An extractor maps
uint8 images [N, H, W, C] to (features [N, D], class probabilities [N, K])
as numpy arrays; its ``fingerprint`` names the feature map (backend and
weights), and the feature caches of eval/sampling_io.py are keyed by it.

  * :class:`InceptionExtractor`: the InceptionV3 of eval/inception_v3.py on
    the card, with weights from ``<assetdir>/inception_v3_weights.npz``.
    Its fingerprint is ``torch:<md5 of the npz>``, so caches the JAX
    package wrote (``flax:...``) are recomputed, not mixed in.
  * :class:`DummyFeatureExtractor`: a fixed random projection, for tests
    and runs without Inception weights; its numbers are not comparable to
    published ones, and it says so.

The JAX package's TF-Hub backend needs cached TF-Hub modules and is not
ported.

Resizes to Inception's 299 px: ``'host'`` is cleanfid's PIL bicubic per
channel on float32 (:func:`clean_resize`; needs Pillow). ``'device'`` is
``jax.image.resize``'s 'cubic' (Keys, a = -0.5, half-pixel centres, taps
outside the image dropped and the rest renormalised) as two products with
the weight matrices of :func:`resize_weights`, on the images' device; it
takes inputs under 299 px only, larger ones go the host way, as in JAX.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..data.resize import resize_weights
from ..utils.device import resolve_device
from .inception_v3 import load_params_npz

log = logging.getLogger(__name__)

INCEPTION_DEFAULT_IMAGE_SIZE = 299
WEIGHTS_FILE = "inception_v3_weights.npz"


def resize(x: torch.Tensor, out_h: int, out_w: int, method: str,
           antialias: bool = True) -> torch.Tensor:
  """``jax.image.resize`` of float NCHW ``x`` to [N, C, out_h, out_w]:
  a product with :func:`resize_weights` over each axis whose size
  changes, on ``x``'s device, in ``x``'s dtype."""
  h, w = x.shape[-2:]
  if w != out_w:
    ww = resize_weights(w, out_w, method, antialias)
    x = torch.matmul(x, torch.as_tensor(ww, dtype=x.dtype, device=x.device))
  if h != out_h:
    wh = resize_weights(h, out_h, method, antialias)
    x = torch.matmul(torch.as_tensor(wh.T, dtype=x.dtype, device=x.device),
                     x)
  return x


def clean_resize(images: np.ndarray, size: int = 299) -> np.ndarray:
  """cleanfid's 'clean' resize: PIL bicubic per channel on float32.

  images: [N, H, W, C] uint8 or float in [0, 255]. Returns float32
  [N, size, size, C] in the same range. Needs Pillow, imported here."""
  from PIL import Image

  images = np.asarray(images)
  n, _, _, c = images.shape
  out = np.empty((n, size, size, c), dtype=np.float32)
  for i in range(n):
    for ch in range(c):
      img = Image.fromarray(images[i, :, :, ch].astype(np.float32), mode="F")
      img = img.resize((size, size), resample=Image.BICUBIC)
      out[i, :, :, ch] = np.asarray(img, dtype=np.float32)
  return out


class FeatureExtractor:
  """uint8 images [N, H, W, C] -> (features [N, D], probabilities [N, K]
  or None), numpy. ``fingerprint`` names the feature map, backend and
  weights."""

  name = "base"
  feature_dim = 2048
  fingerprint = "base"

  def __call__(self, images_uint8: np.ndarray):
    raise NotImplementedError


class DummyFeatureExtractor(FeatureExtractor):
  """A fixed random projection (``RandomState(0)``) of the images resized
  to 16x16 (linear, antialiased), then tanh, a second projection and a
  softmax; on the CPU. For tests and runs without Inception weights: its
  FID and IS are consistent with each other and nothing else."""

  name = "dummy"

  def __init__(self, feature_dim: int = 16, num_classes: int = 10):
    self.feature_dim = feature_dim
    self.num_classes = num_classes
    self.fingerprint = f"dummy:{feature_dim}x{num_classes}"
    rng = np.random.RandomState(0)
    self._proj = torch.from_numpy(
        rng.normal(0, 1, size=(16 * 16 * 3, feature_dim)).astype(np.float32))
    self._cls = torch.from_numpy(
        rng.normal(0, 1, size=(feature_dim, num_classes)).astype(np.float32))
    log.warning("DummyFeatureExtractor in use: FID/IS values are NOT "
                "comparable to published numbers.")

  def __call__(self, images_uint8: np.ndarray):
    x = torch.from_numpy(np.asarray(images_uint8)).float() / 127.5 - 1.0
    n, _, _, c = x.shape
    x = resize(x.permute(0, 3, 1, 2), 16, 16, "linear").permute(0, 2, 3, 1)
    if c == 1:
      x = x.repeat(1, 1, 1, 3)
    feats = x.reshape(n, -1) @ self._proj
    probs = torch.softmax(torch.tanh(feats) @ self._cls, dim=-1)
    return feats.numpy(), probs.numpy()


def _md5(path: str) -> str:
  h = hashlib.md5()
  with open(path, "rb") as f:
    for chunk in iter(lambda: f.read(1 << 22), b""):
      h.update(chunk)
  return h.hexdigest()


class InceptionExtractor(FeatureExtractor):
  """InceptionV3 pool3 features and class probabilities on ``device``,
  ``batch_size`` images per forward. ``resize_mode`` 'device' sends the
  uint8 images to the device and resizes them there (inputs under 299 px);
  'host' resizes on the host with :func:`clean_resize` (Pillow)."""

  name = "torch"

  def __init__(self, weights_path: str, batch_size: int = 128,
               resize_mode: str = "host", device="cuda"):
    if resize_mode not in ("host", "device"):
      raise ValueError(f"resize_mode must be 'host' or 'device', not "
                       f"{resize_mode!r}")
    self.device = resolve_device(device)
    self.model = load_params_npz(weights_path).to(self.device)
    self.batch_size = batch_size
    self.resize_mode = resize_mode
    self.fingerprint = f"torch:{_md5(weights_path)[:12]}"

  @torch.inference_mode()
  def __call__(self, images_uint8: np.ndarray):
    s = INCEPTION_DEFAULT_IMAGE_SIZE
    on_device = (self.resize_mode == "device"
                 and images_uint8.shape[1] < s and images_uint8.shape[2] < s)
    feats, probs = [], []
    for i in range(0, len(images_uint8), self.batch_size):
      chunk = images_uint8[i:i + self.batch_size]
      if on_device:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        x = resize(x.permute(0, 3, 1, 2).float(), s, s, "cubic")
      else:
        x = torch.from_numpy(clean_resize(chunk, s)).to(self.device)
        x = x.permute(0, 3, 1, 2)
      f, p = self.model(x)
      feats.append(f.cpu().numpy())
      probs.append(p.cpu().numpy())
    return np.concatenate(feats), np.concatenate(probs)


def get_feature_extractor(config, assetdir: Optional[str] = None,
                          allow_dummy: bool = True,
                          device="cuda") -> FeatureExtractor:
  """The Inception of ``<assetdir>/inception_v3_weights.npz`` on
  ``device``, resizing as ``config.tpu.fid_resize`` says ('host' without a
  config); else the dummy with a warning, or, without ``allow_dummy``,
  RuntimeError. A weights file that fails to load raises: it never
  becomes the dummy."""
  if assetdir:
    weights = os.path.join(assetdir, WEIGHTS_FILE)
    if os.path.exists(weights):
      tpu = config.get("tpu") if config is not None else None
      mode = tpu.get("fid_resize", "host") if tpu is not None else "host"
      return InceptionExtractor(weights, resize_mode=mode, device=device)
  if allow_dummy:
    return DummyFeatureExtractor()
  raise RuntimeError(f"No Inception backend available: provide "
                     f"<assetdir>/{WEIGHTS_FILE} (tools/convert_inception_"
                     f"weights.py, or eval.inception_v3.save_params_npz of "
                     f"random_params), or allow the dummy extractor.")
