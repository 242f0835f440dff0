"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout,
named by a hash of the source and flags, and loaded with ``ctypes``. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside it as ``.log``. Importing this module needs neither ``nvcc``
nor a card. :func:`launch` calls a loaded entry point on the current
stream of a tensor's device.

Each kernel is also an operator of the ``soft_truncation`` namespace
(:func:`define_op`), so that ``torch.export`` and the compiler see it as one
opaque node: a CPU implementation (the kernel's plain version), a CUDA one
(the launch) and a fake one (the output's shape, dtype and device). Eager
calls go through the operator too: ``PERF.md`` gives the dispatcher's cost
per call on the card's host, a few microseconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NAMESPACE = "soft_truncation"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  from torch.utils.cpp_extension import CUDA_HOME
  if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
    return os.path.join(CUDA_HOME, "bin", "nvcc")
  raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                     "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
  """Where the library for ``csrc/<name>.cu`` lives once built."""
  src = (_CSRC / f"{name}.cu").read_bytes()
  digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
  return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
  """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
  out = library_path(name)
  if not out.exists():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                         f"\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
  return ctypes.CDLL(str(out))


def launch(fn, device: torch.device, *args) -> int:
  """``fn(*args, stream)`` on ``device`` with its current raw CUDA stream:
  the entry points launch on the current device, and the raw stream
  handle spares building a ``torch.cuda.Stream`` object on every call."""
  index = device.index
  if index == torch._C._cuda_getDevice():
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))
  with torch.cuda.device(index):
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def define_op(name: str, schema: str, cpu, cuda, fake):
  """Define the operator ``soft_truncation::<name><schema>`` with its CPU,
  CUDA and fake implementations; returns its overload."""
  _LIBRARY.define(name + schema)
  _LIBRARY.impl(name, cpu, "CPU")
  _LIBRARY.impl(name, cuda, "CUDA")
  torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
  return getattr(getattr(torch.ops, NAMESPACE), name).default


def tracing() -> bool:
  """Whether the call is being traced (``torch.export``, ``torch.compile``):
  its tensors have no storage, no data pointer and no version counter."""
  return torch.compiler.is_compiling()
