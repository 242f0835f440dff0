"""Image resizes on the host, in numpy: TensorFlow's antialiased
``tf.image.resize`` and the dataset ops built on it, and the weight
matrices they share with ``jax.image.resize``.

TF's antialiased resize (``scale_and_translate``) and ``jax.image.resize``
use one algorithm: per output pixel, the kernel (triangle for 'bilinear',
Keys' cubic with a = -0.5 for 'bicubic') at half-pixel centres, widened by
in/out when shrinking, taps outside the image dropped and the rest
renormalised to sum 1. :func:`resize_weights` builds that [in, out] matrix
once per (in, out, method) in float64; a resize is two products with it,
one per axis. ``eval/inception.py`` applies the same matrices on the card.

The dataset ops are copies of the JAX package's
(``soft_truncation_tpu/data/datasets.py``), on a batch [B, H, W, C]:
``crop_resize`` (centre square, bicubic, then TF's cast to uint8, which
saturates where the bicubic overshoots [0, 255] and truncates toward zero
inside), ``resize_small`` (short side to the resolution, the other
``int(side * ratio)``, bilinear) and ``central_crop``.
"""

from __future__ import annotations

import functools

import numpy as np


def _keys_cubic(x: np.ndarray) -> np.ndarray:
  """Keys' cubic kernel, a = -0.5, of |offset| ``x``."""
  out = ((1.5 * x - 2.5) * x) * x + 1.0
  out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
  return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
  return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@functools.lru_cache(maxsize=None)
def resize_weights(in_len: int, out_len: int, method: str,
                   antialias: bool = True) -> np.ndarray:
  """[in_len, out_len] float64 weights of ``jax.image.resize`` along one
  axis (``jax._src.image.scale.compute_weight_mat``, scale out/in, no
  translation): the kernel widened by in/out when downsampling with
  ``antialias``, each output's weights renormalised to sum 1, and outputs
  whose sample point lies outside the input zeroed. Cached: treat the
  result as read-only."""
  inv_scale = in_len / out_len
  kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
  sample_f = (np.arange(out_len) + 0.5) * inv_scale - 0.5
  x = np.abs(sample_f[None, :] - np.arange(in_len)[:, None]) / kernel_scale
  weights = _KERNELS[method](x)
  total = weights.sum(axis=0, keepdims=True)
  weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                     weights / np.where(total != 0, total, 1), 0.0)
  inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
  return np.where(inside[None, :], weights, 0.0)


_TF_METHODS = {"bilinear": "linear", "bicubic": "cubic"}


def tf_resize(images: np.ndarray, out_h: int, out_w: int,
              method: str = "bilinear") -> np.ndarray:
  """``tf.image.resize(images, [out_h, out_w], method, antialias=True)`` of
  a batch [B, H, W, C]: float32 out, whatever the input's dtype (uint8
  values stay on [0, 255]). An axis already at its size is left as it is,
  which is what the weights would give."""
  x = np.asarray(images, dtype=np.float32)
  kernel = _TF_METHODS[method]
  h, w = x.shape[1:3]
  if h != out_h:
    wh = resize_weights(h, out_h, kernel).astype(np.float32)
    x = np.einsum("bhwc,hH->bHwc", x, wh, optimize=True)
  if w != out_w:
    ww = resize_weights(w, out_w, kernel).astype(np.float32)
    x = np.einsum("bhwc,wW->bhWc", x, ww, optimize=True)
  return np.ascontiguousarray(x, dtype=np.float32)


def convert_to_float(images: np.ndarray) -> np.ndarray:
  """``tf.image.convert_image_dtype(uint8 -> float32)``: x * f32(1/255)."""
  return images.astype(np.float32) * np.float32(1.0 / 255.0)


def tf_cast_uint8(x: np.ndarray) -> np.ndarray:
  """``tf.cast(float32 -> uint8)`` of an image: TF's vectorised cast (any
  tensor of 32 elements or more) saturates to [0, 255] and truncates
  toward zero. (Its scalar path, under 32 elements, wraps modulo 256
  instead; no image is that small.)"""
  return np.clip(x, 0.0, 255.0).astype(np.uint8)


def crop_resize(images: np.ndarray, resolution: int) -> np.ndarray:
  """Centre-crop to a square, bicubic resize to ``resolution``, uint8 out."""
  h, w = images.shape[1:3]
  crop = min(h, w)
  images = images[:, (h - crop) // 2:(h + crop) // 2,
                  (w - crop) // 2:(w + crop) // 2]
  return tf_cast_uint8(tf_resize(images, resolution, resolution, "bicubic"))


def resize_small(images: np.ndarray, resolution: int) -> np.ndarray:
  """Shrink (bilinear) so that the short side equals ``resolution``."""
  h, w = images.shape[1:3]
  ratio = resolution / min(h, w)
  return tf_resize(images, int(h * ratio), int(w * ratio))


def central_crop(images: np.ndarray, size: int) -> np.ndarray:
  """The centred ``size`` x ``size`` window; raises, as TF does, where the
  image is smaller."""
  h, w = images.shape[1:3]
  top, left = (h - size) // 2, (w - size) // 2
  if top < 0 or left < 0:
    raise ValueError(f"central_crop of {size}x{size} from a {h}x{w} image")
  return images[:, top:top + size, left:left + size]
