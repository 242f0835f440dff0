"""cleanfid's public functions over the port's extractors and metrics.

Counterpart of ``soft_truncation_tpu/eval/cleanfid_api.py``: features of
the ``samples_*.npz`` shards of a folder (cached as
``features_<extractor>.npz``), FID against a second folder, a stats npz or
a stream of real images, and KID. A stream is any iterable of uint8 NHWC
batches, such as ``data.get_eval_iterator(config)``.
"""

from __future__ import annotations

import glob
import os
from typing import Iterable, Optional, Tuple

import numpy as np

from . import sampling_io
from .evaluation import compute_dataset_stats, stream_features
from .inception import FeatureExtractor, get_feature_extractor
from .metrics import compute_stats, frechet_distance, kernel_distance


def get_folder_features(fdir: str, extractor: FeatureExtractor,
                        num_data: Optional[int] = None,
                        cache: bool = True) -> np.ndarray:
  """The features of every ``samples_*.npz`` shard under ``fdir``, in the
  shards' name order, cached in ``fdir`` under the extractor's
  fingerprint (``sampling_io.fingerprinted_npz``)."""

  def compute():
    shards = sorted(glob.glob(os.path.join(fdir, "samples_*.npz")))
    if not shards:
      raise FileNotFoundError(f"no samples_*.npz under {fdir}")
    feats = []
    for path in shards:
      with np.load(path) as f:
        samples = f["samples"]
      if samples.dtype != np.uint8:
        raise ValueError(f"{path}: samples must be uint8, got "
                         f"{samples.dtype}")
      feats.append(extractor(samples)[0])
    return {"features": np.concatenate(feats)}

  feats = sampling_io.fingerprinted_npz(
      os.path.join(fdir, f"features_{extractor.name}.npz") if cache
      else None, getattr(extractor, "fingerprint", None), compute,
      "folder-feature")["features"]
  return feats[:num_data] if num_data else feats


def get_statistics_from_dataset(batches: Iterable[np.ndarray],
                                extractor: FeatureExtractor, num_data: int,
                                cache_path: Optional[str] = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
  """(mu, cov) of the first ``num_data`` images of a stream of uint8
  batches, cached in ``cache_path`` when given
  (``evaluation.compute_dataset_stats``)."""
  return compute_dataset_stats(None, batches, extractor, num_data,
                               cache_path=cache_path)


def compute_fid(fdir1: Optional[str] = None, fdir2: Optional[str] = None,
                stats_npz: Optional[str] = None, dataset=None,
                extractor: Optional[FeatureExtractor] = None,
                num_data: Optional[int] = None,
                assetdir: Optional[str] = None, device="cuda") -> float:
  """FID between the shards of ``fdir1`` and those of ``fdir2``, the
  moments of ``stats_npz`` or the first ``num_data`` images of
  ``dataset`` (a stream of uint8 batches)."""
  extractor = extractor or get_feature_extractor(None, assetdir,
                                                 device=device)
  mu1, cov1 = compute_stats(get_folder_features(fdir1, extractor, num_data))
  if fdir2 is not None:
    mu2, cov2 = compute_stats(get_folder_features(fdir2, extractor,
                                                  num_data))
  elif stats_npz is not None:
    with np.load(stats_npz) as f:
      mu2, cov2 = f["mu"], f["cov"]
  elif dataset is not None:
    if num_data is None:
      raise ValueError("streaming a dataset needs num_data")
    mu2, cov2 = get_statistics_from_dataset(dataset, extractor, num_data)
  else:
    raise ValueError("need fdir2, stats_npz, or dataset")
  return frechet_distance(mu1, cov1, mu2, cov2)


def compute_kid(fdir1: str, fdir2: Optional[str] = None, dataset=None,
                extractor: Optional[FeatureExtractor] = None,
                num_data: Optional[int] = None) -> float:
  """KID between the shards of ``fdir1`` and those of ``fdir2`` or the
  images of ``dataset`` (a stream of uint8 batches)."""
  extractor = extractor or get_feature_extractor(None, None)
  feats1 = get_folder_features(fdir1, extractor, num_data)
  if fdir2 is not None:
    feats2 = get_folder_features(fdir2, extractor, num_data)
  else:
    feats2 = stream_features(dataset, extractor, num_data)
  return kernel_distance(feats1, feats2)
