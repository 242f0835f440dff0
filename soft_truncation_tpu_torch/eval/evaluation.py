"""Evaluation: FID, KID and IS over sample shards, and the likelihood loops.

Counterpart of ``soft_truncation_tpu/eval/evaluation.py``.
:func:`compute_fid_and_is` samples ``num_data`` images in shards of
``sampling.batch_size`` (resumable, eval/sampling_io.py), featurises them
(eval/inception.py) and compares them with the real images' statistics:
an npz of the assetdir (:func:`load_dataset_stats`), else the evaluation
images streamed through the same extractor (:func:`compute_dataset_stats`).
:func:`compute_bpd` runs the NELBO and exact-NLL loops.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import data as datasets
from . import sampling_io
from .inception import get_feature_extractor
from .metrics import (compute_stats, frechet_distance,
                      inception_score_from_probs, kernel_distance)

log = logging.getLogger(__name__)

_STATS_FILES = {
    "CIFAR10": "cifar10_stats.npz",
    "IMAGENET32": "imagenet32_stats.npz",
    "CELEBA": "celeba_stats.npz",
    "CelebAHQ": "celeba-hq.npz",
    "STL10": "stl10_stats.npz",
}


def load_dataset_stats(config, assetdir: str, mode: str = "clean"):
  """The real images' statistics from ``assetdir``: ``(mu, cov,
  real_feats)``. The file holds moments (``mu`` and ``cov`` or ``sigma``)
  or raw Inception ``pool_3`` activations ([N, D], or [N, 1, 1, D] as
  tfgan writes them), or both; moments are computed from ``pool_3`` when
  absent, and ``real_feats`` (which KID needs) is None without it. A
  dataset without a stats file name raises ValueError, a file with
  neither KeyError, a missing file FileNotFoundError."""
  if config.data.dataset == "LSUN":
    filename = (f"LSUN_{config.data.category}_"
                f"{config.data.image_size}_{mode}_stats.npz")
  else:
    filename = _STATS_FILES.get(config.data.dataset)
  if filename is None:
    raise ValueError(f"Dataset {config.data.dataset} stats not found.")
  path = os.path.join(assetdir, filename)
  with np.load(path) as stats:
    real_feats = None
    if "pool_3" in stats:
      real_feats = np.asarray(stats["pool_3"])
      if real_feats.ndim > 2:
        real_feats = real_feats.reshape(real_feats.shape[0], -1)
    if "mu" in stats:
      mu = np.asarray(stats["mu"])
      cov = np.asarray(stats["cov"] if "cov" in stats else stats["sigma"])
    elif real_feats is not None:
      mu, cov = compute_stats(real_feats)
    else:
      raise KeyError(
          f"{path} has neither (mu, cov|sigma) moments nor raw pool_3 "
          f"features; keys: {sorted(stats.files)}")
  return mu, cov, real_feats


def stream_features(batches: Iterable[np.ndarray], extractor,
                    num_data: Optional[int]) -> np.ndarray:
  """The features of the first ``num_data`` images (all without it) of
  ``batches`` (uint8 NHWC arrays, or float32 ones in [0, 1], which are
  taken to uint8 as the JAX package does: clipped ``x * 255``, truncated),
  read no further than they need."""
  feats, seen = [], 0
  for imgs in batches:
    if imgs.dtype != np.uint8:
      imgs = np.clip(imgs * 255.0, 0, 255).astype(np.uint8)
    feats.append(extractor(imgs)[0])
    seen += len(imgs)
    if num_data and seen >= num_data:
      break
  return np.concatenate(feats)[:num_data]


def compute_dataset_stats(config, batches: Iterable[np.ndarray], extractor,
                          num_data: int, cache_path: Optional[str] = None):
  """(mu, cov) of the first ``num_data`` images of ``batches`` (uint8
  NHWC arrays, read once) through ``extractor``, cached in ``cache_path``
  when given, under the extractor's fingerprint
  (``sampling_io.fingerprinted_npz``)."""
  got = sampling_io.fingerprinted_npz(
      cache_path, getattr(extractor, "fingerprint", None),
      lambda: dict(zip(("mu", "cov"), compute_stats(stream_features(
          batches, extractor, num_data)))), "real-stats")
  return got["mu"], got["cov"]


def shard_seed(seed: int, r: int) -> int:
  """The sampler's generator seed for shard ``r`` of a run seeded ``seed``."""
  return int(np.random.SeedSequence([seed, r]).generate_state(1,
                                                              np.uint64)[0])


def compute_fid_and_is(config, model, sampling_fn, step: int, sample_dir: str,
                       assetdir: Optional[str], num_data: int,
                       eval_ds: Optional[Iterable[np.ndarray]] = None,
                       extractor=None, device="cuda") -> dict:
  """Sample, featurise, and report FID, KID and IS of checkpoint ``step``.

  ``(num_data - 1) // sampling.batch_size + 1`` shards, shard r sampled
  from a generator seeded ``shard_seed(config.seed, r)``; shard r + 1 is
  issued before shard r is read and featurised, and a shard issued but not
  yet written when anything raises is written before the exception goes
  on, so a rerun resumes after it. The real side: ``assetdir``'s stats
  npz, else ``eval_ds`` (uint8 batches, one pass) through the same
  extractor. IS when the extractor gives probabilities, KID when the
  assetdir npz holds raw features, then FID (nan, with ``fid_error``, when
  the root is degenerate). The metrics go to ``report_metrics.npz`` in the
  shard directory and are returned. The extractor, unless given, is
  :func:`get_feature_extractor`'s on ``device``."""
  extractor = extractor or get_feature_extractor(config, assetdir,
                                                 device=device)
  batch = config.sampling.batch_size
  num_rounds = (num_data - 1) // batch + 1
  t_start = time.perf_counter()
  all_feats, all_probs = [], []
  pending = None  # (round, handle) issued and not yet read
  inflight = {}   # round -> handle issued and not yet written
  try:
    for r in range(num_rounds + 1):
      handle = None
      if r < num_rounds:
        handle = sampling_io.begin_samples(
            config, model, sampling_fn, step, r, sample_dir,
            seed=shard_seed(config.seed, r))
        inflight[r] = handle
      if pending is not None:
        rp, hp = pending
        samples = sampling_io.finish_samples(hp)
        inflight.pop(rp, None)
        feats, probs = sampling_io.get_latents(config, samples, extractor,
                                               step, rp, sample_dir)
        all_feats.append(feats)
        if probs is not None:
          all_probs.append(probs)
        if rp % 25 == 0 or rp == num_rounds - 1:
          done = (rp + 1) * batch
          log.info("sampling shard %d/%d (%d imgs, %.1f imgs/s incl. "
                   "featurize+IO)", rp + 1, num_rounds, done,
                   done / max(time.perf_counter() - t_start, 1e-9))
      pending = (r, handle) if handle is not None else None
  except BaseException:
    for rp, hp in list(inflight.items()):
      try:
        sampling_io.finish_samples(hp)
      except Exception:  # the first exception is the one to report
        log.warning("could not persist in-flight sample shard %d", rp,
                    exc_info=True)
    raise
  feats = np.concatenate(all_feats)[:num_data]
  mu, cov = compute_stats(feats)

  real_feats = None
  try:
    if assetdir is None:
      raise FileNotFoundError("no assetdir given")
    mu_ref, cov_ref, real_feats = load_dataset_stats(config, assetdir)
  except (FileNotFoundError, ValueError, KeyError):
    if eval_ds is None:
      raise ValueError("no precomputed stats and no eval dataset to stream")
    cache = os.path.join(sample_dir, f"real_stats_{extractor.name}.npz")
    mu_ref, cov_ref = compute_dataset_stats(config, eval_ds, extractor,
                                            num_data, cache_path=cache)

  # IS and KID first: a degenerate covariance product makes FID raise
  metrics = {}
  if all_probs:
    metrics["inception_score"] = inception_score_from_probs(
        np.concatenate(all_probs)[:num_data])
  if real_feats is not None:
    metrics["kid"] = kernel_distance(real_feats, feats)
  try:
    metrics["fid"] = frechet_distance(mu_ref, cov_ref, mu, cov)
  except ValueError as e:
    log.error("FID failed (%s); reporting nan FID alongside the other "
              "metrics", e)
    metrics["fid"] = float("nan")
    metrics["fid_error"] = str(e)

  report = os.path.join(sampling_io.get_dir_name(config, sample_dir, step),
                        "report_metrics.npz")
  np.savez_compressed(report, **metrics)
  log.info("ckpt-%d metrics: %s", step, metrics)
  return metrics


def compute_bpd(config, nelbo_fn, nll_fn, model, step: int = 0,
                report_dir: Optional[str] = None, device="cuda") -> dict:
  """``eval.nelbo_iter`` batches of the single-sample NELBO (plus the
  residual when ``eval.residual``) and ``eval.nll_iter`` batches of the
  exact NLL (mode 'correct' with the residual, else 'wrong'), each loop
  from the first evaluation batch (``data.eval_batches``), with t
  down to ``training.truncation_time``. Logs the running mean and std of
  each loop, the NLL batches' nfe and wall, and writes the results to
  ``report_dir/bpd_<step>.npz`` when given. Draws (the uniform
  dequantization, then each batch's) come from a generator seeded with
  ``config.seed + 1``."""
  device = torch.device(device)
  generator = torch.Generator(device).manual_seed(config.seed + 1)
  preprocess = datasets.make_preprocess_fn(config)
  eps = config.training.truncation_time
  mode = "correct" if config.eval.residual else "wrong"
  results = {}

  def batches(count):
    for _, batch in zip(range(count), datasets.eval_batches(config)):
      yield preprocess(torch.from_numpy(batch).to(device), generator)

  vals = []
  for i, batch in enumerate(batches(config.eval.nelbo_iter)):
    nelbo, residual = nelbo_fn(model, batch, generator, eps=eps)
    total = nelbo + residual if config.eval.residual else nelbo
    vals.append(total.cpu().numpy())
    every = np.concatenate(vals)
    log.info("step %d nelbo batch %d: mean %.5f std %.5f", step, i,
             every.mean(), every.std())
  if vals:
    every = np.concatenate(vals)
    results["nelbo_bpd_mean"] = float(every.mean())
    results["nelbo_bpd_std"] = float(every.std())

  vals = []
  for i, batch in enumerate(batches(config.eval.nll_iter)):
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    bpd, _, nfe = nll_fn(model, batch, generator, eps=eps, mode=mode)
    vals.append(bpd.cpu().numpy())
    wall = time.perf_counter() - t0
    every = np.concatenate(vals)
    log.info("step %d nll batch %d: mean %.5f std %.5f (nfe %d, %.3f s, "
             "%.3f ms per function evaluation)", step, i, every.mean(),
             every.std(), nfe, wall, wall / nfe * 1e3)
  if vals:
    every = np.concatenate(vals)
    results["nll_bpd_mean"] = float(every.mean())
    results["nll_bpd_std"] = float(every.std())

  log.info("step %d bpd results: %s", step, results)
  if report_dir and results:
    os.makedirs(report_dir, exist_ok=True)
    np.savez_compressed(os.path.join(report_dir, f"bpd_{step}.npz"),
                        **results)
  return results
