"""The profiler hooks of the port (soft_truncation_tpu_torch/utils/
profiling.py) and ``config.tpu.profile_dir`` in the CLI trainer, on the
CPU: the trace of the run's eleventh step (the step the JAX package
traces) is written as Chrome JSON and holds the step's ops, the FIR
adjoint's autograd node among them."""

import json
import os

import torch

from soft_truncation_tpu_torch import main as cli
from soft_truncation_tpu_torch.utils import profiling

import torch_tiny


def test_trace_writes_chrome_json_and_no_dir_is_a_no_op(tmp_path):
  with profiling.trace(None):
    torch.ones(3).sum()
  with profiling.trace(str(tmp_path)):
    torch.ones(64, 64).matmul(torch.ones(64, 64))
  with open(tmp_path / profiling.TRACE_FILE) as f:
    events = json.load(f)["traceEvents"]
  assert any("mm" in e.get("name", "") for e in events)


def test_step_timer_reports_steps_and_images_per_second():
  timer = profiling.StepTimer(batch_size=8)
  for _ in range(4):
    timer.tick()
  sps, ips = timer.report()
  assert sps > 0 and ips == 8 * sps
  assert timer.report()[0] == 0.0


def test_the_trainer_traces_its_eleventh_step(tmp_path):
  trace_dir = tmp_path / "trace"
  cli.main(["--config", torch_tiny.PORT_UNCSNPP, "--workdir",
            str(tmp_path / "w"), "--mode", "train", "--cpu",
            "--config.tpu.profile_dir", str(trace_dir),
            "--config.training.n_iters", "11",
            "--config.training.log_freq", "100",
            "--config.training.snapshot_freq", "100",
            "--config.data.dataset", "Synthetic",
            "--config.data.image_size", "8", "--config.model.nf", "8",
            "--config.model.ch_mult", "(1,2)",
            "--config.model.num_res_blocks", "1",
            "--config.model.attn_resolutions", "(4,)",
            "--config.training.batch_size", "2"])
  assert os.listdir(trace_dir) == [profiling.TRACE_FILE]
  with open(trace_dir / profiling.TRACE_FILE) as f:
    names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
  # one step: the down and the up res-block's two resamples each take the
  # adjoint (the input pyramid's downsampling of the images takes none)
  assert sum(n == "_Fir2Backward" for n in names) == 4
