"""Training and evaluation data: sources, the host batch iterators and the
device-side preprocessing.

Counterpart of ``soft_truncation_tpu/data/datasets.py`` for the training and
likelihood slices. Sources, as the JAX package resolves them for a
resident-array pipeline:

  1. ``<dataset>_<split>.npz`` (an ``images`` uint8 NHWC array at the final
     size) under ``config.data.data_dir`` or ``$SOFT_TRUNCATION_DATA_DIR``
     (``tools/make_dataset_npz.py`` writes them);
  2. else the deterministic Synthetic images (low-frequency 4x4 noise
     upsampled bilinearly, plus N(0, 8) noise), with a warning; the same
     arrays as the JAX package's.

Evaluation (:func:`get_eval_iterator`) reads the whole evaluation split of
the dataset, as the JAX package names it (:func:`eval_split`: 'test' for
CIFAR-10, 10,000 images; 'validation' for LSUN and IMAGENET32; 'train' for
a dataset it does not list, such as Synthetic), once, in an order shuffled
from a seed, at ``eval.batch_size`` (the last batch may be short), without
flips. The eval-loss, NELBO and NLL loops take :func:`eval_batches`, which
starts a new pass when one ends, as the JAX package's ``get_batch`` does.

Batches are uint8 on the host, [B, H, W, C], drawn by :class:`BatchIterator`
(a fresh permutation per epoch and a random left-right flip, from a seeded
numpy generator); the order cannot match tf.data's
10k-element shuffle buffer, so the port and the JAX package see the same
images in a different order. :func:`make_preprocess_fn` turns a batch into
model input on the device: x 1/255 (or the uniform dequantization
``(k + u) / 256``), then the scaler.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


def get_data_scaler(config):
  """Map data in [0, 1] to model space ([-1, 1] when centered)."""
  if config.data.centered:
    return lambda x: x * 2.0 - 1.0
  return lambda x: x


def get_data_inverse_scaler(config):
  """Map model-space samples back to [0, 1]."""
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x


def make_preprocess_fn(config, dequantize: bool = True):
  """``preprocess(batch, generator)``: a uint8 batch on the device ->
  scaled float32 model input; the dequantization noise (``data.
  dequantization`` 'uniform', unless ``dequantize`` is False, as for the
  eval loss) comes from ``generator``."""
  scaler = get_data_scaler(config)
  dequant = dequantize and config.data.dequantization == "uniform"

  def preprocess(batch: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    if batch.dtype != torch.uint8:
      raise ValueError(f"batches are uint8, got {batch.dtype}")
    x = batch.float()
    if dequant:
      u = torch.rand(x.shape, generator=generator, device=x.device)
      x = (x + u) * np.float32(1.0 / 256.0)
    else:
      x = x * np.float32(1.0 / 255.0)
    return scaler(x)

  return preprocess


def _data_dir(config) -> Optional[str]:
  return (config.data.get("data_dir", None)
          or os.environ.get("SOFT_TRUNCATION_DATA_DIR"))


def load_npz_array(config, split: str = "train") -> Optional[np.ndarray]:
  """The ``images`` array of ``<dataset>_<split>.npz``, or None."""
  root = _data_dir(config)
  if not root:
    return None
  path = os.path.join(root, f"{config.data.dataset.lower()}_{split}.npz")
  if not os.path.exists(path):
    return None
  with np.load(path) as f:
    images = f["images"]
  if images.dtype != np.uint8 or images.ndim != 4:
    raise ValueError(f"{path}: images must be uint8 NHWC, got "
                     f"{images.dtype} {images.shape}")
  log.info("loaded %s: %d images from %s", config.data.dataset, len(images),
           path)
  return images


def _bilinear_upsample_np(a: np.ndarray, out_len: int, axis: int
                          ) -> np.ndarray:
  """Half-pixel bilinear interpolation along one axis (numpy, host)."""
  in_len = a.shape[axis]
  x = (np.arange(out_len) + 0.5) * (in_len / out_len) - 0.5
  xf = np.floor(x).astype(np.int64)
  x0 = np.clip(xf, 0, in_len - 1)
  x1 = np.clip(xf + 1, 0, in_len - 1)
  frac = np.clip(x - xf, 0.0, 1.0).astype(a.dtype)
  shape = [1] * a.ndim
  shape[axis] = out_len
  f = frac.reshape(shape)
  return np.take(a, x0, axis=axis) * (1 - f) + np.take(a, x1, axis=axis) * f


def synthetic_array(config, split: str = "train") -> np.ndarray:
  """Deterministic stand-in data (uint8 NHWC) for data-less machines."""
  n = 2048 if split != "train" else 8192
  size = config.data.image_size
  c = config.data.num_channels
  log.warning("SYNTHETIC DATA in use for %s/%s: no real dataset found. Set "
              "SOFT_TRUNCATION_DATA_DIR to a directory of npz arrays.",
              config.data.dataset, split)
  rng = np.random.RandomState(0 if split == "train" else 1)
  base = rng.randint(0, 256, size=(n, 4, 4, c)).astype(np.float32)
  imgs = _bilinear_upsample_np(_bilinear_upsample_np(base, size, axis=1),
                               size, axis=2)
  imgs = imgs + rng.normal(0, 8, size=(n, size, size, c))
  return np.clip(imgs, 0, 255).astype(np.uint8)


class BatchIterator:
  """Endless uint8 batches [B, H, W, C] of ``images``: a permutation per
  epoch (the remainder dropped), each image flipped left-right with
  probability 1/2 when ``random_flip``."""

  def __init__(self, images: np.ndarray, batch_size: int, random_flip: bool,
               seed):
    if len(images) < batch_size:
      raise ValueError(f"{len(images)} images make no batch of "
                       f"{batch_size}")
    self.images, self.batch_size = images, batch_size
    self.random_flip = random_flip
    self.rng = np.random.default_rng(seed)
    self._order, self._pos = None, len(images)

  def __iter__(self) -> Iterator[np.ndarray]:
    return self

  def __next__(self) -> np.ndarray:
    if self._pos + self.batch_size > len(self.images):
      self._order, self._pos = self.rng.permutation(len(self.images)), 0
    idx = self._order[self._pos:self._pos + self.batch_size]
    self._pos += self.batch_size
    batch = self.images[idx]
    if self.random_flip:
      flip = self.rng.random(self.batch_size) < 0.5
      batch[flip] = batch[flip, :, ::-1]
    return batch


def get_train_iterator(config, seed) -> BatchIterator:
  """The training batches of ``config.data.dataset`` (see module
  docstring), at ``config.training.batch_size``, shuffled and flipped from
  ``seed`` (anything ``np.random.default_rng`` takes)."""
  images = load_npz_array(config, "train")
  if images is None:
    images = synthetic_array(config, "train")
  want = (config.data.image_size, config.data.image_size,
          config.data.num_channels)
  if images.shape[1:] != want:
    raise ValueError(f"training images must be {want} (resize the npz "
                     f"beforehand), got {images.shape[1:]}")
  return BatchIterator(images, config.training.batch_size,
                       config.data.random_flip, seed)


# (train, eval) split of each dataset: soft_truncation_tpu/data/datasets.py
_SPLITS = {
    "CIFAR10": ("train", "test"),
    "CIFAR100": ("train", "test"),
    "SVHN": ("train", "test"),
    "CELEBA": ("train", "test"),
    "STL10": ("train", "test"),
    "LSUN": ("train", "validation"),
    "IMAGENET32": ("train", "validation"),
}


def eval_split(config) -> str:
  """The split evaluation reads: the JAX package's, 'train' where it lists
  none."""
  return _SPLITS.get(config.data.dataset, ("train", "train"))[1]


def get_eval_iterator(config) -> Iterator[np.ndarray]:
  """One pass over the evaluation images (module docstring) as uint8
  batches [B, H, W, C]; the order is shuffled from ``config.seed``, so
  every call yields the same batches."""
  split = eval_split(config)
  images = load_npz_array(config, split)
  if images is None:
    images = synthetic_array(config, split)
  want = (config.data.image_size, config.data.image_size,
          config.data.num_channels)
  if images.shape[1:] != want:
    raise ValueError(f"evaluation images must be {want}, got "
                     f"{images.shape[1:]}")
  order = np.random.default_rng(config.seed).permutation(len(images))
  size = config.eval.batch_size
  for start in range(0, len(images), size):
    yield images[order[start:start + size]]


def eval_batches(config) -> Iterator[np.ndarray]:
  """The batches of :func:`get_eval_iterator`, pass after pass, without
  end."""
  while True:
    yield from get_eval_iterator(config)
