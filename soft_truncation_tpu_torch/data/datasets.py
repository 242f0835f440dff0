"""Data scaling. Counterpart of ``soft_truncation_tpu/data/datasets.py``
for the serving slice: only the inverse scaler. The data pipelines come
with ROADMAP.md slice 2."""

from __future__ import annotations


def get_data_inverse_scaler(config):
  """Map model-space samples back to [0, 1]."""
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x
