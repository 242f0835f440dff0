"""Training and evaluation data: sources, the dataset's resize, the host
batch iterators and the device-side preprocessing.

Counterpart of ``soft_truncation_tpu/data/datasets.py``. Sources, as the
JAX package resolves them:

  1. for FFHQ and CelebAHQ, the score_sde TFRecord file at
     ``config.data.tfrecords_path`` when it exists (``data/tfrecords.py``);
  2. ``<dataset>_<split>.npz`` (an ``images`` uint8 NHWC array) under
     ``config.data.data_dir`` or ``$SOFT_TRUNCATION_DATA_DIR``
     (``tools/make_dataset_npz.py`` writes them);
  3. else the deterministic Synthetic images (low-frequency 4x4 noise
     upsampled bilinearly, plus N(0, 8) noise), with a warning; the same
     arrays as the JAX package's up to 90^2, fewer of them above
     (:data:`SYNTHETIC_MAX_BYTES`), so that 1024^2 fits in a host's memory.

Every source then goes through the dataset's resize, JAX's ``_resize_op``
(:func:`resize_op`, the TF ops of ``data/resize.py`` in numpy): CELEBA is
cropped to its central 140 x 140 and shrunk; LSUN is cropped to a square
and resized bicubically (at 128 px: shrunk, then cropped); any other
dataset is resized to the config's size (antialiased bilinear: nothing
moves when it is already there). The result is float32 in [0, 1]. Where
JAX's ``transport_uint8`` says its values lie on the k/255 grid (CIFAR-10,
Synthetic and the others at their native size), the batch is carried as
uint8 (``round(x * 255)``, exact there); elsewhere (CELEBA, LSUN, FFHQ,
CelebA-HQ, a resized CIFAR-10) as float32. JAX carries its evaluation
batches as float32 always; the port carries them as uint8 wherever the
resize leaves them on the grid, which gives the model the same input
(x * f32(1/255) either way; the uniform dequantization of a uint8 batch
rounds once where JAX's float chain rounds twice, within an ulp).

Evaluation (:func:`get_eval_iterator`) reads the whole evaluation split of
the dataset, as the JAX package names it (:func:`eval_split`: 'test' for
CIFAR-10, 10,000 images; 'validation' for LSUN and IMAGENET32; 'train' for
a dataset it does not list, such as Synthetic), once, in an order shuffled
from a seed, at ``eval.batch_size`` (the last batch may be short), without
flips. The eval-loss, NELBO and NLL loops take :func:`eval_batches`, which
starts a new pass when one ends, as the JAX package's ``get_batch`` does.

Training batches are drawn by :class:`BatchIterator` (a fresh permutation
per epoch, the resize, then a random left-right flip, from a seeded numpy
generator); the order cannot match tf.data's 10k-element shuffle buffer,
so the port and the JAX package see the same images in a different
order. :func:`make_preprocess_fn` turns a batch into model input on the
device: x 1/255 (or the uniform dequantization ``(k + u) / 256``) for
uint8, ``(255 x + u) / 256`` for float32, then the scaler.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import resize
from .tfrecords import TFRecordImages

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
  """``preprocess(batch, generator)``: a uint8 batch, or a float32 one in
  [0, 1], on the device -> scaled float32 model input; the dequantization
  noise (``data.dequantization`` 'uniform', unless ``dequantize`` is
  False, as for the eval loss) comes from ``generator``."""
  scaler = get_data_scaler(config)
  dequant = dequantize and config.data.dequantization == "uniform"

  def preprocess(batch: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    if batch.dtype not in (torch.uint8, torch.float32):
      raise ValueError(f"batches are uint8 or float32, got {batch.dtype}")
    x = batch.float()
    u = (torch.rand(x.shape, generator=generator, device=x.device)
         if dequant else None)
    if batch.dtype == torch.uint8:
      x = (x + u) * np.float32(1.0 / 256.0) if dequant else (
          x * np.float32(1.0 / 255.0))
    elif dequant:
      x = (255.0 * x + u) / 256.0
    return scaler(x)

  return preprocess


def transport_uint8(config) -> bool:
  """Whether training batches travel as uint8: the JAX package's
  ``transport_uint8``. ``data.transport_dtype`` 'uint8' or 'float32'
  decides; 'auto' says uint8 only where the dataset's values stay on the
  k/255 grid: Synthetic, and the uint8 sources at their native size."""
  mode = config.data.get("transport_dtype", "auto")
  if mode not in ("auto", "uint8", "float32"):
    raise ValueError(f"config.data.transport_dtype must be 'auto', "
                     f"'uint8' or 'float32', got {mode!r}")
  if mode != "auto":
    return mode == "uint8"
  if config.data.dataset == "Synthetic":
    return True
  native_sizes = {"CIFAR10": 32, "CIFAR100": 32, "SVHN": 32,
                  "IMAGENET32": 32, "STL10": 96}
  return native_sizes.get(config.data.dataset) == config.data.image_size


def resize_op(config) -> Callable[[np.ndarray], np.ndarray]:
  """JAX's ``_resize_op`` on a batch: uint8 [B, H, W, C] -> float32
  [B, size, size, C] in [0, 1]."""
  dataset, size = config.data.dataset, config.data.image_size
  if dataset == "CELEBA":
    return lambda b: resize.resize_small(
        resize.central_crop(resize.convert_to_float(b), 140), size)
  if dataset == "LSUN" and size == 128:
    return lambda b: resize.central_crop(
        resize.resize_small(resize.convert_to_float(b), size), size)
  if dataset == "LSUN":
    return lambda b: resize.convert_to_float(resize.crop_resize(b, size))
  return lambda b: resize.tf_resize(resize.convert_to_float(b), size, size)


def host_transform(config, evaluation: bool = False
                   ) -> Callable[[np.ndarray], np.ndarray]:
  """A source's uint8 batch -> the batch the device takes: the resize,
  then uint8 again where :func:`transport_uint8` says so (``round(x *
  255)``, exact on the grid), else float32. An evaluation batch is uint8
  wherever the resize leaves it on the grid (LSUN's bicubic crop, which
  ends in a cast to uint8, or a batch already at its size), else float32.
  A batch the resize would not move is passed through as it is."""
  op = resize_op(config)
  dataset, size = config.data.dataset, config.data.image_size
  plain = dataset not in ("CELEBA", "LSUN")
  exact_ok = transport_uint8(config) or evaluation
  to_uint8 = transport_uint8(config) or (evaluation and dataset == "LSUN"
                                         and size != 128)

  def transform(batch: np.ndarray) -> np.ndarray:
    if exact_ok and plain and batch.shape[1:3] == (size, size):
      return batch
    x = op(batch)
    return np.rint(x * 255.0).astype(np.uint8) if to_uint8 else x

  return transform


def _data_dir(config) -> Optional[str]:
  return (config.data.get("data_dir", None)
          or os.environ.get("SOFT_TRUNCATION_DATA_DIR"))


def load_tfrecords(config) -> Optional[TFRecordImages]:
  """The images of ``config.data.tfrecords_path``, or None where it is
  unset or missing."""
  path = config.data.get("tfrecords_path", None)
  if not path or not os.path.exists(path):
    return None
  images = TFRecordImages(path)
  log.info("loaded %s: %d images from %s", config.data.dataset, len(images),
           path)
  return images


def load_source(config, split: str):
  """The images of ``split``, by the order of sources in the module
  docstring: an array-like uint8 [N, H, W, C]."""
  images = None
  if config.data.dataset in ("FFHQ", "CelebAHQ"):
    images = load_tfrecords(config)
  if images is None:
    images = load_npz_array(config, split)
  if images is None:
    images = synthetic_array(config, split)
  return images


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


# the Synthetic images' bytes at most: JAX's 8,192 (train) or 2,048 images
# up to 90^2 (CIFAR-10, CelebA 64^2), fewer above (85 at 1024^2, where JAX's
# 8,192 would take 26 GB as uint8 and 206 GB as they are drawn)
SYNTHETIC_MAX_BYTES = 2 ** 28


def synthetic_array(config, split: str = "train") -> np.ndarray:
  """Deterministic stand-in data (uint8 NHWC) for data-less machines: the
  JAX package's images, as many as SYNTHETIC_MAX_BYTES hold, drawn a chunk
  of images at a time (the same stream)."""
  size = config.data.image_size
  c = config.data.num_channels
  n = 2048 if split != "train" else 8192
  n = max(1, min(n, SYNTHETIC_MAX_BYTES // (size * size * c)))
  log.warning("SYNTHETIC DATA in use for %s/%s: no real dataset found. Set "
              "SOFT_TRUNCATION_DATA_DIR to a directory of npz arrays.",
              config.data.dataset, split)
  rng = np.random.RandomState(0 if split == "train" else 1)
  base = rng.randint(0, 256, size=(n, 4, 4, c)).astype(np.float32)
  out = np.empty((n, size, size, c), np.uint8)
  chunk = max(1, 2 ** 24 // (size * size * c))
  for i in range(0, n, chunk):
    b = base[i:i + chunk]
    imgs = _bilinear_upsample_np(_bilinear_upsample_np(b, size, axis=1),
                                 size, axis=2)
    imgs = imgs + rng.normal(0, 8, size=(len(b), size, size, c))
    out[i:i + chunk] = np.clip(imgs, 0, 255).astype(np.uint8)
  return out


class BatchIterator:
  """Endless batches [B, H, W, C] of ``images`` (a uint8 array or any
  array-like that takes an index array): a permutation per epoch (the
  remainder dropped), ``transform`` (e.g. :func:`host_transform`) of each
  batch, then each image flipped left-right with probability 1/2 when
  ``random_flip``."""

  def __init__(self, images, batch_size: int, random_flip: bool, seed,
               transform: Optional[Callable] = None):
    if len(images) < batch_size:
      raise ValueError(f"{len(images)} images make no batch of "
                       f"{batch_size}")
    self.images, self.batch_size = images, batch_size
    self.random_flip = random_flip
    self.transform = transform
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
    if self.transform is not None:
      batch = self.transform(batch)
    if self.random_flip:
      flip = self.rng.random(self.batch_size) < 0.5
      batch[flip] = batch[flip, :, ::-1]
    return batch


def get_train_iterator(config, seed) -> BatchIterator:
  """The training batches of ``config.data.dataset`` (see module
  docstring), at ``config.training.batch_size``, shuffled and flipped from
  ``seed`` (anything ``np.random.default_rng`` takes)."""
  return BatchIterator(load_source(config, "train"),
                       config.training.batch_size, config.data.random_flip,
                       seed, host_transform(config))


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
  """One pass over the evaluation images (module docstring) as batches
  [B, H, W, C], uint8 or float32 as :func:`host_transform` makes them; the
  order is shuffled from ``config.seed``, so every call yields the same
  batches."""
  images = load_source(config, eval_split(config))
  transform = host_transform(config, evaluation=True)
  order = np.random.default_rng(config.seed).permutation(len(images))
  size = config.eval.batch_size
  for start in range(0, len(images), size):
    yield transform(images[order[start:start + size]])


def eval_batches(config) -> Iterator[np.ndarray]:
  """The batches of :func:`get_eval_iterator`, pass after pass, without
  end."""
  while True:
    yield from get_eval_iterator(config)
