"""Metric math: FID (Frechet distance), KID (polynomial-kernel MMD) and the
Inception Score.

Counterpart of ``soft_truncation_tpu/eval/metrics.py``: the same numpy and
scipy calls in float64 on moments of 2048-d features (the features
themselves come from the Inception of eval/inception_v3.py, on the card).
:func:`frechet_distance_torch` is the Newton-Schulz counterpart of the JAX
package's on-device FID: f32 on a tensor's device, within ~1e-3 of
:func:`frechet_distance`, which stays the one that reports numbers.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import scipy.linalg
import torch


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """(mu, sigma) of an [N, D] feature matrix, in float64."""
  features = np.asarray(features, dtype=np.float64)
  return features.mean(axis=0), np.cov(features, rowvar=False)


def _sqrtm(a: np.ndarray) -> np.ndarray:
  """Matrix square root across scipy's removal of ``disp`` (the tuple form
  is deprecated; the new form returns the matrix alone and never prints:
  callers check finiteness)."""
  with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    try:
      out = scipy.linalg.sqrtm(a, disp=False)
      return out[0] if isinstance(out, tuple) else out
    except TypeError:  # scipy >= 1.18: no disp argument
      return scipy.linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
  """FID between two Gaussians. A non-finite root is retried with ``eps``
  on the diagonals, and so is a rank-deficient product whose root has an
  imaginary diagonal (fewer samples than feature dims); a root still
  non-finite or imaginary raises ``ValueError``."""
  mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
  mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
  sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
  sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))
  if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
    raise ValueError(f"moments of different shapes: {mu1.shape} "
                     f"{sigma1.shape} vs {mu2.shape} {sigma2.shape}")

  diff = mu1 - mu2
  offset = np.eye(sigma1.shape[0]) * eps
  covmean = _sqrtm(sigma1.dot(sigma2))
  if not np.isfinite(covmean).all():
    covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
  if np.iscomplexobj(covmean):
    if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
      covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
      if (np.iscomplexobj(covmean)
          and not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3)):
        raise ValueError(
            f"Imaginary component {np.max(np.abs(covmean.imag))}")
    covmean = covmean.real
  if not np.isfinite(covmean).all():
    raise ValueError("sqrtm(sigma1 @ sigma2) is non-finite even after "
                     "eps-regularization; covariance inputs are degenerate")
  return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
               - 2 * np.trace(covmean))


def frechet_distance_torch(mu1, sigma1, mu2, sigma2, num_iters: int = 50,
                           device=None) -> torch.Tensor:
  """FID with the root of sigma1 @ sigma2 by ``num_iters`` Newton-Schulz
  iterations, in f32 on ``device`` (default: ``sigma1``'s if a tensor,
  else the CPU). Returns a 0-d tensor there."""
  if device is None:
    device = sigma1.device if torch.is_tensor(sigma1) else "cpu"

  def f32(a):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device)

  mu1, mu2, s1, s2 = f32(mu1), f32(mu2), f32(sigma1), f32(sigma2)
  a = s1 @ s2
  norm = torch.linalg.norm(a)
  eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
  y, z = a / norm, eye
  for _ in range(num_iters):
    t = 0.5 * (3.0 * eye - z @ y)
    y, z = y @ t, t @ z
  diff = mu1 - mu2
  return (diff @ diff + torch.trace(s1) + torch.trace(s2)
          - 2.0 * torch.trace(y * torch.sqrt(norm)))


def kernel_distance(feats1: np.ndarray, feats2: np.ndarray,
                    num_subsets: int = 100,
                    max_subset_size: int = 1000) -> float:
  """KID: the cubic polynomial-kernel MMD, averaged over ``num_subsets``
  subsets of m = min(n1, n2, max_subset_size) drawn from RandomState(0)."""
  feats1 = np.asarray(feats1, dtype=np.float64)
  feats2 = np.asarray(feats2, dtype=np.float64)
  n = feats1.shape[1]
  m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
  t = 0.0
  rng = np.random.RandomState(0)
  for _ in range(num_subsets):
    x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
    y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
    a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
    b = (x @ y.T / n + 1) ** 3
    t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
  return float(t / num_subsets / m)


def inception_score_from_probs(probs: np.ndarray,
                               num_splits: int = 10) -> float:
  """IS = exp(E KL(p(y|x) || p(y))), averaged over ``num_splits`` splits
  (tfgan's classifier score)."""
  probs = np.asarray(probs, dtype=np.float64)
  scores = []
  n = probs.shape[0]
  for i in range(num_splits):
    part = probs[i * n // num_splits:(i + 1) * n // num_splits]
    if len(part) == 0:
      continue
    py = part.mean(axis=0, keepdims=True)
    kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
    scores.append(np.exp(kl.sum(axis=1).mean()))
  return float(np.mean(scores))
