"""Sample quantisation and PNG grids. Counterpart of the parts of
``soft_truncation_tpu/eval/sampling_io.py`` that serving uses."""

from __future__ import annotations

import numpy as np
import torch


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
  """[0, 1] floats -> uint8, clipped and then truncated toward zero."""
  return torch.clamp(x * 255.0, 0, 255).to(torch.uint8)


def save_image_grid(samples_uint8: np.ndarray, path, max_images: int = 64,
                    format: str | None = None) -> None:
  """Save a PNG grid of NHWC uint8 samples. ``path`` may be a file object
  (then pass ``format``). Needs PIL, imported here and only here."""
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
