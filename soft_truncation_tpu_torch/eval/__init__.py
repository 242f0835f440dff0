"""Evaluation of the PyTorch port: FID, KID and IS over sample shards, the
likelihood loops, and sample I/O."""

from .evaluation import compute_bpd, compute_fid_and_is, load_dataset_stats
from .metrics import (compute_stats, frechet_distance,
                      inception_score_from_probs, kernel_distance)

__all__ = [
    "frechet_distance",
    "kernel_distance",
    "inception_score_from_probs",
    "compute_stats",
    "compute_bpd",
    "compute_fid_and_is",
    "load_dataset_stats",
]
