"""Data-parallel training of the port (soft_truncation_tpu_torch/parallel/
ddp.py) with two gloo processes on the CPU, launched as ``torchrun``
launches them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) through the CLI trainer.

Two ranks on the tiny flagship (dropout 0.1, two micro-batches, so one of
them accumulates under ``no_sync``) must train as one process on the same
global batch: after one step the last step's snapshot's parameters and EMA
within 1e-6, and Adam's moments within 1e-5 of their largest value (the
sums over the batch are reassociated across the ranks). Then both resume
from the one process's checkpoint (every rank restores it) for one more
step, to the same bars in the rolling checkpoint. Then the mesh check and
the shard of the global batch.

Adam's ``eps`` is 1e-3 here, not the configs' 1e-8: an update is lr * g /
(|g| + eps), whose gain near g = 0 is lr / eps, so at 1e-8 a weight whose
gradient is ~1e-9 moves by a few percent of lr apart for a 1e-10 change of
its gradient, which the reassociated sums make (measured: 1.1e-5 on one of
9,216 weights). At 1e-3 the gain is 0.2 and the parameters show the
gradients' agreement.
"""

import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from soft_truncation_tpu_torch import main as cli
from soft_truncation_tpu_torch.configs.base import default_config
from soft_truncation_tpu_torch.parallel import ddp

import torch_tiny

FLAGS = ["--config.data.dataset", "Synthetic",
         "--config.data.image_size", "16", "--config.model.nf", "16",
         "--config.model.ch_mult", "(1,2)",
         "--config.model.num_res_blocks", "1",
         "--config.model.attn_resolutions", "(8,)",
         "--config.model.init_scale", "0.1",
         "--config.training.batch_size", "8",
         "--config.optim.num_micro_batch", "2",
         "--config.optim.warmup", "0", "--config.optim.eps", "1e-3",
         "--config.training.log_freq", "1",
         "--config.training.snapshot_freq", "1000",
         "--config.training.snapshot_freq_for_preemption", "1"]


def _argv(workdir, n_iters):
  return ["--config", torch_tiny.PORT_FLAGSHIP, "--workdir", str(workdir),
          "--mode", "train", "--cpu",
          "--config.training.n_iters", str(n_iters)] + FLAGS


def _free_port() -> int:
  s = socket.socket()
  s.bind(("localhost", 0))
  port = s.getsockname()[1]
  s.close()
  return port


def _two_ranks(workdir, n_iters, meanwhile):
  """The CLI trainer on two gloo ranks, ``meanwhile()`` run while they
  train; returns each rank's output."""
  env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
             MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
             OMP_NUM_THREADS="1",
             PYTHONPATH=torch_tiny.REPO + os.pathsep
             + os.environ.get("PYTHONPATH", ""))
  procs = [subprocess.Popen(
      [sys.executable, "-m", "soft_truncation_tpu_torch.main"]
      + _argv(workdir, n_iters),
      env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=torch_tiny.REPO,
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(2)]
  meanwhile()
  outs = [p.communicate(timeout=300)[0] for p in procs]
  for r, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
  return outs


def _checkpoint(workdir, snapshot=False):
  """The rolling checkpoint, or the numbered snapshot of the last step."""
  path = (os.path.join(workdir, "checkpoints", "checkpoint_0") if snapshot
          else os.path.join(workdir, "checkpoints-meta", "checkpoint"))
  return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Two ranks and one process, step 0; then both resumed from the one
  process's checkpoint, step 1."""
  ranks, alone = (tmp_path_factory.mktemp(d) for d in ("ranks", "alone"))
  out = {}
  out["ranks"] = _two_ranks(ranks, 0, lambda: cli.main(_argv(alone, 0)))
  out["first"] = _checkpoint(ranks, True), _checkpoint(alone, True)
  for workdir in (ranks, alone):
    shutil.copy(os.path.join(alone, "checkpoints", "checkpoint_0"),
                os.path.join(workdir, "checkpoints-meta", "checkpoint"))
  out["resumed_ranks"] = _two_ranks(ranks, 1,
                                    lambda: cli.main(_argv(alone, 1)))
  out["resumed"] = _checkpoint(ranks), _checkpoint(alone)
  out["log"] = (ranks / "stdout.txt").read_text()
  return out


def _assert_same_state(got, want):
  assert got["step"] == want["step"]
  checked = 0
  for part in ("model", "ema"):
    for k, w in want[part].items():
      torch.testing.assert_close(got[part][k], w, rtol=0, atol=1e-6)
      checked += 1
  for k in ("mu", "nu"):
    largest = max(w.abs().max().item() for w in want["optimizer"][k])
    for g, w in zip(got["optimizer"][k], want["optimizer"][k]):
      torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * largest)
  assert checked > 50


def _moved(state):
  return sum(1 for v in state["optimizer"]["mu"] if v.abs().max() > 0)


def test_two_ranks_step_as_one_process(runs):
  got, want = runs["first"]
  assert want["step"] == 1 and _moved(want) > 20
  _assert_same_state(got, want)
  for out in runs["ranks"]:
    assert "Starting training loop at step 0." in out


def test_two_ranks_save_restore_and_resume(runs):
  got, want = runs["resumed"]
  assert want["step"] == 2
  _assert_same_state(got, want)
  for out in runs["resumed_ranks"]:  # every rank restored the checkpoint
    assert "Starting training loop at step 1." in out
    assert "checkpoint loaded" in out
  # rank 0 alone writes the workdir's log, one line per step
  assert runs["log"].count("training loss mean") == 2


def test_the_mesh_is_the_world():
  config = default_config()
  ddp.check_mesh(config, ddp.World())
  config.tpu.mesh_shape = (2,)
  ddp.check_mesh(config, ddp.World(rank=1, size=2, launched=True))
  with pytest.raises(ValueError):
    ddp.check_mesh(config, ddp.World())
  config.tpu.mesh_shape = (2, 2)
  with pytest.raises(NotImplementedError, match="space"):
    ddp.check_mesh(config, ddp.World(size=4, launched=True))


def test_shard_takes_each_parts_rows():
  batch = torch.arange(16).reshape(16, 1)
  for rank in range(2):
    world = ddp.World(rank=rank, size=2, launched=True)
    rows = ddp.shard(batch, world, parts=2).flatten().tolist()
    # micro-batch 0 is rows 0..7, micro-batch 1 rows 8..15
    assert rows == [4 * rank + i for i in range(4)] + [
        8 + 4 * rank + i for i in range(4)]
  draw = ddp.sharded_draw(lambda kind, shape, high=None: torch.arange(
      int(torch.tensor(shape).prod())).reshape(shape) if shape else
      torch.tensor(-1), rank=1, size=2)
  assert draw("uniform", (3,)).tolist() == [3, 4, 5]
  assert draw("uniform", ()).item() == -1
