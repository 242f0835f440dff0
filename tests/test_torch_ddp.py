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
step, to the same bars in the rolling checkpoint. In the first launch the
ranks also train steps 0..2 at ``tpu.steps_per_dispatch`` 2 (route
'eager' under gloo: a window of 2 and a tail of 1) against one process a
step at a time, to the same bars, logging at JAX's ``_crossed`` labels.
Then the mesh check (the 1-D mesh and the rules of a 2-D one;
tests/test_torch_mesh.py trains on it) and the shard of the global batch.

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
from soft_truncation_tpu_torch.configs.base import default_config, load_config
from soft_truncation_tpu_torch.parallel import ddp

import torch_tiny
from soft_truncation_tpu.run_lib import _crossed as jax_crossed

WINDOW = 2        # tpu.steps_per_dispatch of the windowed run
WINDOW_ITERS = 2  # its last step: a window of 2 and a tail of 1

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


WORKER = os.path.join(torch_tiny.REPO, "tests", "torch_mesh_ranks.py")


def _argv(workdir, n_iters, *flags):
  return ["--config", torch_tiny.PORT_FLAGSHIP, "--workdir", str(workdir),
          "--mode", "train", "--cpu",
          "--config.training.n_iters", str(n_iters)] + FLAGS + list(flags)


def _free_port() -> int:
  s = socket.socket()
  s.bind(("localhost", 0))
  port = s.getsockname()[1]
  s.close()
  return port


def _two_ranks(argvs, meanwhile, spec_dir=None):
  """The CLI trainer on two gloo ranks with each argument list of
  ``argvs`` in turn, ``meanwhile()`` run while they train; returns each
  rank's output. One list runs as ``python -m
  soft_truncation_tpu_torch.main``, as torchrun starts it; more run in
  one process per rank through tests/torch_mesh_ranks.py (its spec and
  results in ``spec_dir``), which joins the group before the first."""
  env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
             MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
             OMP_NUM_THREADS="1",
             PYTHONPATH=torch_tiny.REPO + os.pathsep
             + os.environ.get("PYTHONPATH", ""))
  if len(argvs) == 1:
    cmd = ["-m", "soft_truncation_tpu_torch.main"] + argvs[0]
  else:
    spec = os.path.join(spec_dir, "spec.pt")
    torch.save({"mesh_shape": (), "cli": argvs}, spec)
    cmd = [WORKER, spec, str(spec_dir)]
  procs = [subprocess.Popen(
      [sys.executable] + cmd,
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
  """Two ranks and one process, step 0, and in the same launch steps 0..2
  on the ranks in windows of WINDOW (one of 2, a tail of 1) and in the
  one process a step at a time; then both resumed from the one process's
  checkpoint, step 1."""
  ranks, alone, windows, steps, spec = (
      tmp_path_factory.mktemp(d) for d in ("ranks", "alone", "windows",
                                           "steps", "spec"))
  out = {}

  def alone_runs():
    cli.main(_argv(alone, 0))
    cli.main(_argv(steps, WINDOW_ITERS))

  out["ranks"] = _two_ranks(
      [_argv(ranks, 0), _argv(windows, WINDOW_ITERS,
                              "--config.tpu.steps_per_dispatch",
                              str(WINDOW))], alone_runs, spec)
  out["first"] = _checkpoint(ranks, True), _checkpoint(alone, True)
  out["windows"] = _checkpoint(windows, True), _checkpoint(steps, True)
  out["windows_log"] = (windows / "stdout.txt").read_text()
  for workdir in (ranks, alone):
    shutil.copy(os.path.join(alone, "checkpoints", "checkpoint_0"),
                os.path.join(workdir, "checkpoints-meta", "checkpoint"))
  out["resumed_ranks"] = _two_ranks([_argv(ranks, 1)],
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


def test_two_ranks_train_windows_as_one_process(runs):
  """Steps 0..2 on two gloo ranks in windows of 2 (route 'eager': a
  window of 2, a tail of 1) against one process a step at a time: the
  same state, to the bars of one step; rank 0's log at the step each
  window crosses, as JAX's run_lib._crossed labels it."""
  got, want = runs["windows"]
  assert want["step"] == WINDOW_ITERS + 1
  _assert_same_state(got, want)
  for out in runs["ranks"]:
    assert (f"train windows of {WINDOW} steps: route eager (process group "
            "gloo)") in out
  labels, step0 = [], 0
  while step0 <= WINDOW_ITERS:
    last = min(step0 + WINDOW, WINDOW_ITERS + 1) - 1
    label = jax_crossed(step0, last, 1, allow_zero=True)
    labels += [] if label is None else [label]
    step0 = last + 1
  logged = [int(line.split("step: ")[1].split(",")[0])
            for line in runs["windows_log"].splitlines()
            if "training loss mean" in line]
  assert logged == labels == [1, 2]


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
  # a (data, space) mesh: d * s is the world size, every level's height
  # splits into s shards no thinner than the widest halo
  config = load_config(torch_tiny.PORT_FLAGSHIP)
  config.tpu.mesh_shape = (2, 2)
  ddp.check_mesh(config, ddp.World(size=4, launched=True))
  with pytest.raises(ValueError, match="world size"):
    ddp.check_mesh(config, ddp.World(size=2, launched=True))
  config.tpu.mesh_shape = (1, 3)
  with pytest.raises(ValueError, match="level 0"):
    ddp.check_mesh(config, ddp.World(size=3, launched=True))
  config.tpu.mesh_shape = (1, 8)  # the flagship's 4x4 level: 0.5 rows
  with pytest.raises(ValueError, match="level 3"):
    ddp.check_mesh(config, ddp.World(size=8, launched=True))


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
