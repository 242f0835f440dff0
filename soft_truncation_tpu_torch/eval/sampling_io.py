"""Sample I/O: resumable npz sample shards, PNG grids and cached feature
statistics.

Counterpart of ``soft_truncation_tpu/eval/sampling_io.py``. A shard
``<dir>/samples_<r>.npz`` or a statistics file ``<dir>/statistics_<r>.npz``
that exists is loaded, not made again, so an interrupted evaluation
resumes where it stopped; ``<dir>`` names the checkpoint step and the
sampler's settings (:func:`get_dir_name`, the JAX package's names).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
  """[0, 1] floats -> uint8, clipped and then truncated toward zero."""
  return torch.clamp(x * 255.0, 0, 255).to(torch.uint8)


def get_dir_name(config, sample_dir: str, step: int) -> str:
  """The shard directory of checkpoint ``step`` under ``sample_dir``, named
  by the sampler's settings."""
  s = config.sampling
  if s.method == "pc":
    tag = (f"{s.method}_{s.predictor}_{s.corrector}_snr{s.snr}"
           f"_n{s.n_steps_each}_trunc{s.truncation_time}")
  else:
    tag = f"{s.method}_trunc{s.truncation_time}"
  return os.path.join(sample_dir, f"ckpt_{step}_{tag}")


def save_image_grid(samples_uint8: np.ndarray, path, max_images: int = 64,
                    format: Optional[str] = None) -> None:
  """Save a PNG grid of up to ``max_images`` NHWC uint8 samples, about
  square, in row-major order. ``path`` may be a file object (then pass
  ``format``). Needs PIL, imported here and only here."""
  from PIL import Image

  imgs = samples_uint8[:max_images]
  n = len(imgs)
  cols = int(np.ceil(np.sqrt(n)))
  rows = int(np.ceil(n / cols))
  h, w, c = imgs.shape[1:]
  grid = np.zeros((rows * h, cols * w, c), dtype=np.uint8)
  for i, img in enumerate(imgs):
    r, col = divmod(i, cols)
    grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
  if c == 1:
    grid = grid[..., 0]
  Image.fromarray(grid).save(path, format=format)


def begin_samples(config, model, sampling_fn, step: int, sampling_idx: int,
                  sample_dir: str, seed: Optional[int] = None):
  """Issue one shard of sampling without waiting for the device; returns a
  handle for :func:`finish_samples`. A shard already on disk is not
  sampled again (a ``"cached"`` handle). The sampler draws from a
  generator on the model's device seeded with ``seed`` (default
  ``sampling_idx``); the samples are quantised to uint8 on the device
  and, from a card, copied into pinned host memory behind an event, so
  the caller can issue the next shard before this one is read."""
  dir_name = get_dir_name(config, sample_dir, step)
  os.makedirs(dir_name, exist_ok=True)
  shard_path = os.path.join(dir_name, f"samples_{sampling_idx}.npz")
  if os.path.exists(shard_path):
    return ("cached", shard_path, None)
  device = next(model.parameters()).device
  generator = torch.Generator(device).manual_seed(
      sampling_idx if seed is None else seed)
  samples, nfe = sampling_fn(model, generator)
  samples_u8 = _to_uint8(samples)
  done = None
  if samples_u8.is_cuda:
    host = torch.empty(samples_u8.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(samples_u8, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    samples_u8 = host
  return ("pending", shard_path,
          (samples_u8, done, nfe, dir_name, sampling_idx))


def finish_samples(handle) -> np.ndarray:
  """The uint8 NHWC samples of a :func:`begin_samples` handle: for a fresh
  shard, wait for its copy, then write the shard npz and its PNG grid."""
  kind, shard_path, payload = handle
  if kind == "cached":
    with np.load(shard_path) as f:
      return f["samples"]
  samples_u8, done, nfe, dir_name, sampling_idx = payload
  if done is not None:
    done.synchronize()
  samples = samples_u8.numpy().copy()
  np.savez_compressed(shard_path, samples=samples)
  save_image_grid(samples, os.path.join(dir_name,
                                        f"samples_{sampling_idx}.png"))
  log.info("wrote %s (%d samples, nfe=%s)", shard_path, len(samples), nfe)
  return samples


def get_samples(config, model, sampling_fn, step: int, sampling_idx: int,
                sample_dir: str, seed: Optional[int] = None) -> np.ndarray:
  """One shard of samples (sampled, or loaded), uint8 NHWC."""
  return finish_samples(begin_samples(config, model, sampling_fn, step,
                                      sampling_idx, sample_dir, seed=seed))


def fingerprinted_npz(path: Optional[str], fingerprint: Optional[str],
                      compute, what: str) -> dict:
  """The arrays of the npz cache ``path``, else ``compute()``'s (a dict of
  arrays), written there with ``fingerprint``. A cache written under
  another extractor's fingerprint is computed again; one without a
  fingerprint, or read without one, is trusted. No ``path``, no cache."""
  if path and os.path.exists(path):
    with np.load(path) as f:
      cached = str(f["fingerprint"]) if "fingerprint" in f.files else None
      if cached is None or fingerprint is None or cached == fingerprint:
        return {k: f[k] for k in f.files if k != "fingerprint"}
    log.info("%s cache %s was computed under extractor %s != %s: "
             "recomputing", what, path, cached, fingerprint)
  arrays = compute()
  if path:
    np.savez_compressed(path, **arrays,
                        **({"fingerprint": fingerprint} if fingerprint
                           else {}))
  return arrays


def get_latents(config, samples_uint8: np.ndarray, extractor, step: int,
                sampling_idx: int, sample_dir: str) -> Tuple[np.ndarray,
                                                             np.ndarray]:
  """The features and class probabilities of one shard, cached beside the
  samples as ``statistics_<r>.npz`` (``pool_3``, ``logits`` = the
  probabilities, ``fingerprint``; :func:`fingerprinted_npz`)."""
  dir_name = get_dir_name(config, sample_dir, step)

  def compute():
    feats, probs = extractor(samples_uint8)
    return {"pool_3": feats,
            **({"logits": probs} if probs is not None else {})}

  got = fingerprinted_npz(
      os.path.join(dir_name, f"statistics_{sampling_idx}.npz"),
      getattr(extractor, "fingerprint", None), compute, "feature")
  return got["pool_3"], got.get("logits")


def load_all_statistics(config, sample_dir: str, step: int):
  """Every cached statistics shard of checkpoint ``step``, concatenated:
  (features, probabilities or None), or (None, None) without any."""
  dir_name = get_dir_name(config, sample_dir, step)
  feats, probs = [], []
  for path in sorted(glob.glob(os.path.join(dir_name, "statistics_*.npz"))):
    with np.load(path) as f:
      feats.append(f["pool_3"])
      if "logits" in f.files:
        probs.append(f["logits"])
  if not feats:
    return None, None
  return (np.concatenate(feats),
          np.concatenate(probs) if probs else None)
