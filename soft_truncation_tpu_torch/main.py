"""CLI entry point of the port:

    python -m soft_truncation_tpu_torch.main --config <cfg.py> \\
        --workdir <dir> --mode {train,eval} [--assetdir ...] \\
        [--eval_folder ...] [--cpu] [--config.<section>.<key> <value> ...]

The flags of ``soft_truncation_tpu/main.py``, parsed with argparse. Config
overrides name an existing key, as ``--config.training.n_iters 3`` or
``--config.eval.enable_bpd=False``; the value is read as a Python literal
(``3``, ``1e-3``, ``(1,2)``, ``False``) and kept as text when it is none or
the key holds text. ``--mode train`` trains (``run_lib.train``, log in
``workdir/stdout.txt``; with ``training.snapshot_sampling``, FID, KID and
IS of each snapshot's samples in ``workdir/samples``); ``--mode eval``
evaluates the EMA weights of the workdir's rolling checkpoint: the eval
loss, with ``eval.enable_bpd`` the NELBO and exact-NLL bpd, and with
``eval.enable_sampling`` FID, KID and IS over ``eval.num_samples``
samples (``run_lib.evaluate``, log in ``workdir/evaluation_history.txt``,
reports in ``workdir/<eval_folder>``). ``--assetdir`` holds
``inception_v3_weights.npz`` and the real images' statistics; without the
weights FID runs on a dummy feature extractor and says so. Both modes run
on the card unless ``--cpu`` is given, in float32: TF32 is turned off for
cuDNN's convolutions and for matrix products. Under ``torchrun`` the
trainer is data parallel (``parallel/ddp.py``): every rank logs to stdout,
rank 0 alone to ``workdir``.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import sys

from .configs.base import DTYPE_KNOBS, Config, load_config, tpu_dtype

_PREFIX = "--config."
# keys no config holds, read with ``get`` (as the JAX package reads them),
# that an override may add
OPTIONAL_KEYS = {"tpu.profile_dir"}


def _parse_value(text: str, old):
  if isinstance(old, str):
    return text
  try:
    value = ast.literal_eval(text)
  except (ValueError, SyntaxError):
    return text
  if isinstance(old, float) and isinstance(value, int) and not isinstance(
      value, bool):
    return float(value)
  return value


def apply_overrides(config: Config, args) -> Config:
  """Apply ``--config.a.b value`` / ``--config.a.b=value`` arguments."""
  i = 0
  while i < len(args):
    arg = args[i]
    if not arg.startswith(_PREFIX):
      raise SystemExit(f"unrecognized argument: {arg}")
    if "=" in arg:
      name, text = arg[len(_PREFIX):].split("=", 1)
      i += 1
    else:
      if i + 1 >= len(args):
        raise SystemExit(f"{arg} needs a value")
      name, text = arg[len(_PREFIX):], args[i + 1]
      i += 2
    *path, key = name.split(".")
    node = config
    for part in path:
      if part not in node or not isinstance(node[part], dict):
        raise SystemExit(f"--config.{name}: no config section {part!r}")
      node = node[part]
    if key not in node and name not in OPTIONAL_KEYS:
      raise SystemExit(f"--config.{name}: no such config key")
    node[key] = _parse_value(text, node.get(key, ""))
  return config


def _log_handlers(workdir, filename):
  """Handlers writing the log to stdout and to ``workdir/filename`` (to
  stdout alone for no ``workdir``)."""
  fmt = logging.Formatter(
      "%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
  handlers = [logging.StreamHandler(sys.stdout)]
  if workdir:
    handlers.append(logging.FileHandler(os.path.join(workdir, filename)))
  for handler in handlers:
    handler.setFormatter(fmt)
  return handlers


def _dump_config(config: Config, workdir: str) -> None:
  with open(os.path.join(workdir, "config.txt"), "w") as f:
    for k, v in config.items():
      f.write(f"{k}\n")
      if isinstance(v, dict):
        for k2, v2 in v.items():
          f.write(f"> {k2}: {v2}\n")
      f.write("\n\n")


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--config", required=True, help="config file")
  parser.add_argument("--workdir", required=True, help="work directory")
  parser.add_argument("--mode", required=True, choices=["train", "eval"])
  parser.add_argument("--assetdir", default="assets/stats",
                      help="dataset statistics / inception weights")
  parser.add_argument("--eval_folder", default="eval",
                      help="folder name for evaluation results")
  parser.add_argument("--cpu", action="store_true",
                      help="run on the host instead of the card")
  args, rest = parser.parse_known_args(argv)
  config = apply_overrides(load_config(args.config), rest)
  for knob in DTYPE_KNOBS:
    tpu_dtype(config, knob)  # raises on a value the port does not take
  import torch

  from . import run_lib
  from .parallel import world_from_env
  main_rank = world_from_env().is_main
  # f32 model and Inception: no TF32 in the convolutions or the products;
  # a bf16 model's products sum in f32, as JAX's do (no bf16 reductions)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  os.makedirs(args.workdir, exist_ok=True)
  logger = logging.getLogger()
  logger.setLevel("INFO")
  if main_rank:
    _dump_config(config, args.workdir)
    handlers = _log_handlers(args.workdir, "stdout.txt"
                             if args.mode == "train"
                             else "evaluation_history.txt")
  else:
    handlers = _log_handlers(None, None)
  for handler in handlers:
    logger.addHandler(handler)
  device = "cpu" if args.cpu else "cuda"
  try:
    if args.mode == "train":
      run_lib.train(config, args.workdir, args.assetdir, device=device)
    else:
      run_lib.evaluate(config, args.workdir, args.assetdir, args.eval_folder,
                       device=device)
  finally:
    for handler in handlers:
      logger.removeHandler(handler)
      handler.close()


if __name__ == "__main__":
  main()
