"""The native input pipeline of the port (soft_truncation_tpu_torch/csrc/
batcher.cpp, data/native.py, data/datasets.py's 'native' branch) against
the JAX package's (soft_truncation_tpu/data/native/, data/datasets.py), on
the CPU, bit for bit and without a timing: the C++ entries against JAX's
library and against the port's numpy version, ``NativeBatcher`` over
three epochs, the trainer's uint8 batches and the evaluation chunks
against JAX's pipeline, and the refusals (a pipeline it does not know, a
build that fails: no fallback).
"""

import ctypes

import numpy as np
import pytest

from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu.data import native as jax_native
from soft_truncation_tpu_torch.configs.base import override
from soft_truncation_tpu_torch.data import datasets, native

import torch_tiny

FLAG_SETS = list(range(8))  # flip, dequant, centered: every combination
SHAPES = [(37, 8, 6, 3), (5, 3, 7, 1)]
SEEDS = [0, 123456789, 2 ** 63 + 11]


def _images(shape, seed=0):
  return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assemble(lib, data, idx, flags, seed, dtype=np.float32,
              entry="st_assemble_batch"):
  out = np.empty((len(idx),) + data.shape[1:], dtype)
  ptr = ctypes.POINTER(ctypes.c_float if dtype == np.float32
                       else ctypes.c_uint8)
  idx = np.ascontiguousarray(idx, dtype=np.int64)
  getattr(lib, entry)(data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      *data.shape, idx.ctypes.data_as(
                          ctypes.POINTER(ctypes.c_int64)), len(idx), flags,
                      seed, out.ctypes.data_as(ptr), 4)
  return out


def _shuffled(lib, n, seed):
  idx = np.arange(n, dtype=np.int64)
  lib.st_shuffle_indices(idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         n, seed)
  return idx


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_cpp_entries_match_jax_library_bit_for_bit(flags):
  """The port's st_assemble_batch and st_shuffle_indices against JAX's
  loaded library: the same bits for every flag set, shape and seed."""
  jax_lib = jax_native.get_lib()
  assert jax_lib is not None, "the JAX package's batcher did not build"
  lib = native.load_library()
  for shape in SHAPES:
    data = _images(shape, seed=flags)
    idx = np.random.default_rng(1).integers(0, shape[0], 9)
    for seed in SEEDS:
      want = _assemble(jax_lib, data, idx, flags, seed)
      got = _assemble(lib, data, idx, flags, seed)
      np.testing.assert_array_equal(got.view(np.uint32),
                                    want.view(np.uint32))
      np.testing.assert_array_equal(_shuffled(lib, shape[0], seed + flags),
                                    _shuffled(jax_lib, shape[0],
                                              seed + flags))


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_plain_version_matches_cpp_bit_for_bit(flags):
  """assemble_plain / gather_plain / shuffle_plain (numpy, uint64
  arithmetic) against the port's C++ entries: the same bits."""
  lib = native.load_library()
  for shape in SHAPES:
    data = _images(shape, seed=10 + flags)
    idx = np.random.default_rng(2).integers(0, shape[0], 6)
    for seed in SEEDS:
      got = _assemble(lib, data, idx, flags, seed)
      want = native.assemble_plain(data, idx, flags, seed)
      np.testing.assert_array_equal(got.view(np.uint32),
                                    want.view(np.uint32))
      flip = flags & native.FLAG_RANDOM_FLIP
      np.testing.assert_array_equal(
          _assemble(lib, data, idx, flip, seed, np.uint8,
                    "st_gather_batch_u8"),
          native.gather_plain(data, idx, flip, seed))
      np.testing.assert_array_equal(_shuffled(lib, shape[0], seed),
                                    native.shuffle_plain(
                                        np.arange(shape[0]), seed))


@pytest.mark.parametrize("random_flip", [True, False])
def test_batcher_matches_jax_over_three_epochs(random_flip):
  """JAX's NativeBatcher (its library, not its numpy fallback) and the
  port's from the same images and seed: the same float32 batches, epoch
  after epoch (the remainder dropped), the port's uint8 batches those
  bytes quantized back, and each epoch's batches holding every index once
  (but the remainder)."""
  data = _images((41, 6, 5, 3), seed=3)
  kw = dict(random_flip=random_flip, uniform_dequant=True, centered=True,
            seed=9)
  jax_batcher = jax_native.NativeBatcher(data, 8, **kw)
  assert jax_batcher._lib is not None
  batcher = native.NativeBatcher(data, 8, **kw)
  gather = native.NativeBatcher(data, 8, random_flip=random_flip, seed=9,
                                dtype=np.uint8)
  plain = native.NativeBatcher(data, 8, random_flip=random_flip, seed=9)
  per_epoch = len(data) // 8
  for epoch in range(3):
    seen = []
    for _ in range(per_epoch):
      want, got = next(jax_batcher), next(batcher)
      np.testing.assert_array_equal(got.view(np.uint32),
                                    want.view(np.uint32))
      np.testing.assert_array_equal(next(gather), np.rint(
          next(plain) * 255.0).astype(np.uint8))
      seen.extend(batcher._indices[batcher._pos - 8:batcher._pos])
    assert batcher._epoch == epoch + 1
    assert len(set(seen)) == len(seen) == per_epoch * 8
  assert (batcher._indices != np.arange(len(data))).any()


def _native_configs():
  changes = {"data": dict(dataset="Synthetic", image_size=8,
                          pipeline="native"),
             "training": dict(batch_size=16), "eval": dict(batch_size=2048)}
  jc, pc = torch_tiny.configs({})
  jax_override(jc, changes)
  override(pc, changes)
  return jc, pc


def test_native_train_and_eval_batches_match_jax_pipeline():
  """The trainer's batches under data.pipeline 'native' (uint8, gathered
  directly) against JAX's ``_Uint8Transport(_native_dataset(...))`` (f32
  assembled, then quantized back), and the evaluation chunks against JAX's
  ``_NativeEvalDataset``: bit for bit."""
  jc, pc = _native_configs()
  assert datasets.transport_uint8(pc) and jax_datasets.transport_uint8(jc)
  want = jax_datasets._Uint8Transport(jax_datasets._native_dataset(
      jc, "train", evaluation=False)).as_numpy_iterator()
  got = datasets.get_train_iterator(pc, seed=None)
  assert isinstance(got, native.NativeBatcher) and got.dtype == np.uint8
  for _ in range(600):  # past the first epoch of 8,192 images
    np.testing.assert_array_equal(next(got), next(want)["image"])
  assert got._epoch == 2
  jax_eval = jax_datasets._native_dataset(jc, "train", evaluation=True)
  chunks = list(datasets.get_eval_iterator(pc))
  want_chunks = [d["image"] for d in jax_eval.as_numpy_iterator()]
  assert len(chunks) == len(want_chunks) == 4
  for g, w in zip(chunks, want_chunks):
    assert g.dtype == w.dtype == np.float32
    np.testing.assert_array_equal(g, w)


def test_native_pipeline_refuses_what_jax_refuses(tmp_path):
  """A pipeline neither 'tf' nor 'native' raises (JAX's get_dataset does);
  an npz not at the final size raises (JAX asserts)."""
  _, pc = _native_configs()
  pc.data.pipeline = "grain"
  with pytest.raises(ValueError, match="pipeline must be 'tf' or 'native'"):
    datasets.get_train_iterator(pc, seed=0)
  with pytest.raises(ValueError, match="pipeline"):
    datasets.transport_uint8(pc)
  pc.data.pipeline = "native"
  pc.data.dataset = "CIFAR10"
  np.savez(tmp_path / "cifar10_train.npz", images=_images((20, 6, 6, 3)))
  pc.data.data_dir = str(tmp_path)
  with pytest.raises(ValueError, match="final size"):
    datasets.get_train_iterator(pc, seed=0)


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
  """A compiler that is not there, or that fails, raises with what it
  said; a batcher whose library does not load raises too."""
  load = native.load_library.__wrapped__
  with pytest.raises(RuntimeError, match="could not run"):
    load(compiler=str(tmp_path / "no-such-g++"), build_dir=tmp_path / "a")
  failing = tmp_path / "failing-cxx"
  failing.write_text("#!/bin/sh\necho 'cc1plus: out of cheese' >&2\n"
                     "exit 3\n")
  failing.chmod(0o755)
  with pytest.raises(RuntimeError, match="rc 3(.|\n)*out of cheese"):
    load(compiler=str(failing), build_dir=tmp_path / "b")
  assert not list((tmp_path / "b").glob("*.so"))

  def broken(*args, **kwargs):
    raise RuntimeError("the batcher's build failed")

  monkeypatch.setattr(native, "load_library", broken)
  with pytest.raises(RuntimeError, match="build failed"):
    native.NativeBatcher(_images((8, 2, 2, 1)), 4)
