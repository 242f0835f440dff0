"""The port's trainer around the step: checkpoints, data, the training loop
and its CLI (soft_truncation_tpu_torch/{train/checkpoint,data/datasets,
run_lib,main}.py), on the CPU at a tiny cut.

Data against the JAX package's: the Synthetic images within one uint8 level
(JAX resizes with ``jax.image.resize``, the port with the numpy copy of its
bilinear fallback; a float rounding can cross a level at .5), the
preprocessing exactly (x * f32(1/255), then the scaler) and the uniform
dequantization at 1 ulp (the same (k + u) / 256 from the same u).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu_torch import main as port_main
from soft_truncation_tpu_torch.data import datasets
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.train import (CheckpointManager,
                                             init_train_state,
                                             make_train_step)
from soft_truncation_tpu_torch.sde import get_sde

import torch_tiny
from test_torch_train import TINY

CUT = ["--config.data.image_size", "16", "--config.model.nf", "16",
       "--config.model.ch_mult", "(1,2)", "--config.model.num_res_blocks",
       "1", "--config.model.attn_resolutions", "(8,)",
       "--config.training.batch_size", "4",
       "--config.optim.num_micro_batch", "2",
       "--config.training.log_freq", "1",
       "--config.training.snapshot_freq", "2",
       "--config.training.snapshot_freq_for_preemption", "2",
       "--config.data.dataset", "Synthetic",
       "--config.eval.enable_bpd=False",
       "--config.training.snapshot_sampling=False"]
LOG_LINE = re.compile(r"step: (\d+), training loss mean: (\S+), training "
                      r"loss std: (\S+) \((\S+) steps/s, (\S+) imgs/s\)")


def _state(seed=0, family=torch_tiny.UNCSNPP):
  _, pc = torch_tiny.configs(TINY, family)
  pc.optim.warmup = 0
  return pc, init_train_state(pc, create_model(pc, "cpu", seed=seed))


def _step(pc, state, seed=0):
  gen = torch.Generator().manual_seed(seed)
  x = torch.rand(4, 16, 16, 3, generator=gen)
  make_train_step(pc, get_sde(pc))(state, x, gen)


def _assert_same_state(a, b):
  assert a.step == b.step and a.optimizer.count == b.optimizer.count
  for k, v in a.model.state_dict().items():
    assert torch.equal(v, b.model.state_dict()[k]), k
  for k, v in a.ema.items():
    assert torch.equal(v, b.ema[k]), k
  for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                  b.optimizer.mu + b.optimizer.nu):
    assert torch.equal(x, y)


def test_checkpoint_round_trip_and_rolling_overwrite(tmp_path):
  ckpt = CheckpointManager(str(tmp_path))
  pc, fresh = _state(seed=1)
  assert ckpt.restore_meta(fresh) is None  # nothing to restore
  pc, state = _state()
  _step(pc, state)
  ckpt.save_meta(state)
  ckpt.save_snapshot(state, 1)
  _step(pc, state, seed=1)
  ckpt.save_meta(state)  # the rolling tier is overwritten in place
  assert sorted(os.listdir(tmp_path / "checkpoints-meta")) == ["checkpoint"]
  assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1"]
  assert ckpt.restore_meta(fresh) is fresh
  _assert_same_state(fresh, state)
  assert fresh.step == 2
  ckpt.restore_snapshot(fresh, 1)
  assert fresh.step == 1


def _train(workdir, config, *extra):
  port_main.main(["--config", os.path.join(torch_tiny.PORT_CONFIGS, config),
                  "--workdir", str(workdir), "--mode", "train", "--cpu",
                  *CUT, *extra])
  with open(os.path.join(workdir, "stdout.txt")) as f:
    return [LOG_LINE.search(line) for line in f if LOG_LINE.search(line)]


@pytest.mark.parametrize("config", ["ve/CIFAR10/uncsnpp_st.py",
                                    "vp/CIFAR10/ddpmpp_nll_st.py"])
def test_cli_trains_logs_checkpoints_and_resumes(tmp_path, config):
  lines = _train(tmp_path, config, "--config.training.n_iters", "3")
  assert [int(m.group(1)) for m in lines] == [0, 1, 2, 3]
  for m in lines:
    assert np.isfinite(float(m.group(2))) and float(m.group(4)) > 0
  assert os.listdir(tmp_path / "checkpoints-meta") == ["checkpoint"]
  # snapshots at step 2 and at the last step, both index 3 // 2 == 1
  assert os.listdir(tmp_path / "checkpoints") == ["checkpoint_1"]
  meta = torch.load(tmp_path / "checkpoints-meta" / "checkpoint",
                    weights_only=True)
  assert meta["step"] == 3  # saved after step label 2
  lines = _train(tmp_path, config, "--config.training.n_iters", "5")
  assert [int(m.group(1)) for m in lines] == [0, 1, 2, 3, 3, 4, 5]
  assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1",
                                                          "checkpoint_2"]
  assert torch.load(tmp_path / "checkpoints" / "checkpoint_2",
                    weights_only=True)["step"] == 6


def test_cli_refuses_eval_unknown_keys_and_a_missing_card(tmp_path):
  config = os.path.join(torch_tiny.PORT_CONFIGS, "ve/CIFAR10/uncsnpp_st.py")
  base = ["--config", config, "--workdir", str(tmp_path)]
  with pytest.raises(SystemExit, match="no such config key"):
    port_main.main(base + ["--mode", "train", "--config.training.nope", "1"])
  if not torch.cuda.is_available():
    for mode in ("train", "eval"):
      with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(base + ["--mode", mode] + CUT)


def test_overrides_read_values_as_the_absl_flags_did():
  _, pc = torch_tiny.configs({})
  port_main.apply_overrides(pc, [
      "--config.model.ch_mult", "(1,2)", "--config.optim.lr=1",
      "--config.data.dataset", "Synthetic", "--config.training.st=False",
      "--config.training.n_iters", "7"])
  assert pc.model.ch_mult == (1, 2) and pc.optim.lr == 1.0
  assert isinstance(pc.optim.lr, float)
  assert pc.data.dataset == "Synthetic" and pc.training.st is False
  assert pc.training.n_iters == 7


def test_synthetic_images_match_jax():
  jc, pc = torch_tiny.configs({"data": dict(image_size=8)})
  want = jax_datasets._synthetic_array(jc, "train")
  got = datasets.synthetic_array(pc, "train")
  assert got.shape == want.shape == (8192, 8, 8, 3) and got.dtype == np.uint8
  diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
  assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("dequantization", ["none", "uniform"])
@pytest.mark.parametrize("centered", [False, True])
def test_preprocess_matches_jax(dequantization, centered):
  jc, pc = torch_tiny.configs({"data": dict(dequantization=dequantization,
                                            centered=centered)})
  raw = np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3),
                                          dtype=np.uint8)
  key = jax.random.PRNGKey(3)
  want = np.asarray(jax_datasets.make_preprocess_fn(jc)(jnp.asarray(raw),
                                                        key))
  gen = torch.Generator().manual_seed(0)
  got = datasets.make_preprocess_fn(pc)(torch.from_numpy(raw), gen)
  if dequantization == "uniform":  # the same uniforms on both sides
    u = torch.rand(raw.shape, generator=torch.Generator().manual_seed(0))
    ju = np.asarray(jax.random.uniform(key, raw.shape))
    want = want + (u.numpy() - ju) / 256.0 * (2.0 if centered else 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  else:
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_iterator_permutes_flips_and_reads_the_npz(tmp_path):
  images = np.arange(10 * 2 * 3 * 1, dtype=np.uint8).reshape(10, 2, 3, 1)
  it = datasets.BatchIterator(images, 4, random_flip=False, seed=0)
  seen = np.concatenate([next(it) for _ in range(2)])  # one epoch, 2 left
  assert len({b.tobytes() for b in seen}) == 8
  assert all(any(np.array_equal(b, im) for im in images) for b in seen)
  flipped = datasets.BatchIterator(images, 10, random_flip=True, seed=1)
  batch = next(flipped)
  as_is = sum(any(np.array_equal(b, im) for im in images) for b in batch)
  mirrored = sum(any(np.array_equal(b, im[:, ::-1]) for im in images)
                 for b in batch)
  assert as_is + mirrored == 10 and 0 < mirrored < 10

  _, pc = torch_tiny.configs({"data": dict(image_size=2)})
  pc.data.data_dir, pc.data.num_channels = str(tmp_path), 1
  assert datasets.load_npz_array(pc) is None
  square = np.zeros((6, 2, 2, 1), np.uint8)
  np.savez(tmp_path / "cifar10_train.npz", images=square)
  pc.training.batch_size = 3
  assert next(datasets.get_train_iterator(pc, 0)).shape == (3, 2, 2, 1)
