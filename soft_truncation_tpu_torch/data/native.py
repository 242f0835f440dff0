"""The native input pipeline's batch assembler: ``csrc/batcher.cpp``
through ``ctypes``.

Counterpart of ``soft_truncation_tpu/data/native/__init__.py``. The C++
source is compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` into ``build/host/libbatcher-<hash>.so`` at the root of the
checkout, named by a hash of the source, the compiler and the flags, and
loaded with ``ctypes``; a failed build
raises with the compiler's output. There is no numpy fallback: the JAX
package falls back quietly to a numpy assembler whose random stream differs,
the port does not.

:class:`NativeBatcher` is JAX's, to the bit: an epoch permutation by the
C++ Fisher-Yates shuffle seeded ``seed + epoch``, batches of
``batch_size`` (the remainder of an epoch dropped), each seeded ``(seed +
1) * 1000003 + n * 65537`` for the n-th batch, its item i from ``seed +
i``. Its float32 batches are JAX's; with ``dtype=np.uint8`` (the trainer's
transport) it gathers and flips the uint8 images directly, the bytes of
the float32 batch quantized back (``round(x * 255)``, exact for every
k / 255). :meth:`NativeBatcher.fill` writes a batch into a buffer the
caller holds, such as a slice of a pinned window. ``ctypes`` releases the
GIL for the call, so a batch is assembled while Python runs on.

:func:`assemble_plain`, :func:`gather_plain` and :func:`shuffle_plain` are
the C++ entries in numpy: the same xorshift128+ stream in uint64
arithmetic and the same float32 operations, so bit for bit the C++. The
tests hold the library to them; nothing else calls them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

FLAG_RANDOM_FLIP = 1
FLAG_UNIFORM_DEQUANT = 2
FLAG_CENTERED = 4

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.POINTER(ctypes.c_int64)


def library_path(build_dir: Path = BUILD_DIR, compiler: str = "g++") -> Path:
  """Where the library lives once built: named by a hash of the source,
  the compiler and the flags."""
  digest = hashlib.sha256(SOURCE.read_bytes())
  digest.update(" ".join((compiler,) + CXX_FLAGS).encode())
  return Path(build_dir) / f"libbatcher-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(compiler: str = "g++",
                 build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
  """Compile ``csrc/batcher.cpp`` with ``compiler`` if its library is
  missing, load it and declare its entries. Raises with the compiler's
  output where the build fails."""
  out = library_path(build_dir, compiler)
  if not out.exists():
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
      proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
      raise RuntimeError(f"the batcher's build could not run {cmd[0]}: "
                         f"{e}") from e
    if proc.returncode != 0:
      raise RuntimeError(f"the batcher's build failed (rc {proc.returncode})"
                         f": {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
  lib = ctypes.CDLL(str(out))
  for name, out_type in (("st_assemble_batch", ctypes.c_float),
                         ("st_gather_batch_u8", ctypes.c_uint8)):
    fn = getattr(lib, name)
    fn.argtypes = [_U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, _I64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_uint64, ctypes.POINTER(out_type), ctypes.c_int]
    fn.restype = None
  lib.st_shuffle_indices.argtypes = [_I64, ctypes.c_int64, ctypes.c_uint64]
  lib.st_shuffle_indices.restype = None
  return lib


class NativeBatcher:
  """Epoch-shuffled batches of a resident uint8 [N, H, W, C] array: the
  gather, random flip, uniform dequantization and [0, 1] -> [-1, 1]
  scaling in C++ (module docstring). ``dtype`` float32 (JAX's) or uint8
  (the gather and flip alone: no dequantization or centering)."""

  def __init__(self, images_uint8: np.ndarray, batch_size: int,
               random_flip: bool = True, uniform_dequant: bool = False,
               centered: bool = False, seed: int = 0,
               num_threads: Optional[int] = None, dtype=np.float32):
    if images_uint8.dtype != np.uint8 or images_uint8.ndim != 4:
      raise ValueError(f"images must be uint8 NHWC, got "
                       f"{images_uint8.dtype} {images_uint8.shape}")
    if len(images_uint8) < batch_size:
      raise ValueError(f"{len(images_uint8)} images make no batch of "
                       f"{batch_size}")
    self.dtype = np.dtype(dtype)
    if self.dtype == np.uint8 and (uniform_dequant or centered):
      raise ValueError("uint8 batches take no dequantization or centering")
    if self.dtype not in (np.uint8, np.float32):
      raise ValueError(f"batches are float32 or uint8, not {self.dtype}")
    self.data = np.ascontiguousarray(images_uint8)
    self.batch_size = batch_size
    self.flags = ((FLAG_RANDOM_FLIP if random_flip else 0)
                  | (FLAG_UNIFORM_DEQUANT if uniform_dequant else 0)
                  | (FLAG_CENTERED if centered else 0))
    self.seed = seed
    self.num_threads = num_threads or min(16, os.cpu_count() or 1)
    self._lib = load_library()
    self._indices = np.arange(len(self.data), dtype=np.int64)
    self._pos = len(self.data)  # shuffle before the first batch
    self._epoch = 0
    self._batch_counter = 0

  @property
  def shape(self):
    """The shape of one batch."""
    return (self.batch_size,) + self.data.shape[1:]

  def _reshuffle(self):
    self._epoch += 1
    self._lib.st_shuffle_indices(self._indices.ctypes.data_as(_I64),
                                 len(self._indices), self.seed + self._epoch)
    self._pos = 0

  def __iter__(self):
    return self

  def __next__(self) -> np.ndarray:
    return self.fill(np.empty(self.shape, self.dtype))

  def fill(self, out: np.ndarray) -> np.ndarray:
    """The next batch, written into ``out`` (C-contiguous, of
    :attr:`shape` and this batcher's dtype); returns ``out``."""
    if self._pos + self.batch_size > len(self._indices):
      self._reshuffle()
    idx = self._indices[self._pos:self._pos + self.batch_size]
    self._pos += self.batch_size
    self._batch_counter += 1
    seed = (self.seed + 1) * 1_000_003 + self._batch_counter * 65_537
    return self.assemble(idx, seed, out)

  def assemble(self, idx: np.ndarray, seed: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """The items ``idx`` as one batch seeded ``seed``, into ``out``."""
    if out is None:
      out = np.empty((len(idx),) + self.data.shape[1:], self.dtype)
    if (out.dtype != self.dtype or not out.flags.c_contiguous
        or out.shape != (len(idx),) + self.data.shape[1:]):
      raise ValueError(f"out must be C-contiguous {self.dtype} "
                       f"{(len(idx),) + self.data.shape[1:]}, got "
                       f"{out.dtype} {out.shape}")
    n, h, w, c = self.data.shape
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if self.dtype == np.uint8:
      fn, ptr = self._lib.st_gather_batch_u8, _U8
    else:
      fn, ptr = self._lib.st_assemble_batch, ctypes.POINTER(ctypes.c_float)
    fn(self.data.ctypes.data_as(_U8), n, h, w, c, idx.ctypes.data_as(_I64),
       len(idx), self.flags, seed, out.ctypes.data_as(ptr),
       self.num_threads)
    return out


# ---------------------------------------------------------------------------
# the C++ entries in numpy (the tests' reference)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_ITEM = 0xD1B54A32D192ED03


def _mix(z):
  z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
  z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
  return z ^ (z >> np.uint64(31))


class _Xorshift:
  """xorshift128+ over a uint64 array of seeds: one stream per entry."""

  def __init__(self, seeds):
    with np.errstate(over="ignore"):
      z = np.asarray(seeds, np.uint64) + np.uint64(_GOLDEN)
      self.s0, self.s1 = _mix(z), _mix(z + np.uint64(_GOLDEN))

  def next(self):
    with np.errstate(over="ignore"):
      x, y = self.s0, self.s1
      self.s0 = y
      x = x ^ (x << np.uint64(23))
      self.s1 = x ^ y ^ (x >> np.uint64(17)) ^ (y >> np.uint64(26))
      return self.s1 + y

  def uniform(self):
    return ((self.next() >> np.uint64(40)).astype(np.float32)
            * np.float32(1.0 / 16777216.0))


def _item_streams(idx, seed):
  """Each item's generator: ``(seed + i) ^ (0xD1B5... * (idx + 1))``."""
  i = np.arange(len(idx), dtype=np.uint64)
  with np.errstate(over="ignore"):
    seeds = ((np.uint64(seed & _M64) + i)
             ^ (np.uint64(_ITEM) * (np.asarray(idx, np.uint64)
                                    + np.uint64(1))))
  return _Xorshift(seeds)


def _flips(rng, flags, b):
  if flags & FLAG_RANDOM_FLIP:
    return (rng.next() & np.uint64(1)).astype(bool)
  return np.zeros(b, bool)


def gather_plain(data: np.ndarray, idx, flags: int, seed: int) -> np.ndarray:
  """``st_gather_batch_u8`` in numpy."""
  rng = _item_streams(idx, seed)
  out = data[np.asarray(idx)].copy()
  flip = _flips(rng, flags, len(idx))
  out[flip] = out[flip, :, ::-1]
  return out


def assemble_plain(data: np.ndarray, idx, flags: int,
                   seed: int) -> np.ndarray:
  """``st_assemble_batch`` in numpy: the float32 operations of the C++
  loop, its draws in its order (row, column, channel of the output)."""
  rng = _item_streams(idx, seed)
  b = len(idx)
  flip = _flips(rng, flags, b)
  src = data[np.asarray(idx)]
  src[flip] = src[flip, :, ::-1]
  v = src.astype(np.float32) / np.float32(255.0)
  if flags & FLAG_UNIFORM_DEQUANT:
    flat = v.reshape(b, -1)
    u = np.empty_like(flat)
    for k in range(flat.shape[1]):
      u[:, k] = rng.uniform()
    v = ((np.float32(255.0) * flat + u) / np.float32(256.0)).reshape(v.shape)
  if flags & FLAG_CENTERED:
    v = v * np.float32(2.0) - np.float32(1.0)
  return v


def shuffle_plain(indices: np.ndarray, seed: int) -> np.ndarray:
  """``st_shuffle_indices`` in Python integers: a shuffled copy."""
  out = np.array(indices, dtype=np.int64)
  z = (seed + _GOLDEN) & _M64

  def mix(z):
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)

  s0, s1 = mix(z), mix((z + _GOLDEN) & _M64)
  for i in range(len(out) - 1, 0, -1):
    x, y = s0, s1
    s0 = y
    x ^= (x << 23) & _M64
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
    j = ((s1 + y) & _M64) % (i + 1)
    out[i], out[j] = out[j], out[i]
  return out
