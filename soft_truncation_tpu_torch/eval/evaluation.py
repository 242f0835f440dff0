"""Likelihood evaluation: the NELBO and exact-NLL loops, in bits per dim.

Counterpart of ``soft_truncation_tpu/eval/evaluation.py::compute_bpd``. The
sample-quality metrics of that module (FID, KID, Inception Score) arrive
with ROADMAP.md slice 5.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import data as datasets

log = logging.getLogger(__name__)


def compute_bpd(config, nelbo_fn, nll_fn, model, step: int = 0,
                report_dir: Optional[str] = None, device="cuda") -> dict:
  """``eval.nelbo_iter`` batches of the single-sample NELBO (plus the
  residual when ``eval.residual``) and ``eval.nll_iter`` batches of the
  exact NLL (mode 'correct' with the residual, else 'wrong'), each loop
  from the first evaluation batch (``data.get_eval_iterator``), with t
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
    for _, batch in zip(range(count), datasets.get_eval_iterator(config)):
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
