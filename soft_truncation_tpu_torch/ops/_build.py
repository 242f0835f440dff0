"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout,
named by a hash of the source and flags, and loaded with ``ctypes``. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside it as ``.log``. Importing this module needs neither ``nvcc``
nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
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
