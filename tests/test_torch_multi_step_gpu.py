"""A window of train steps captured as one CUDA graph
(``train/step.py::make_multi_train_step`` with ``tpu.steps_per_dispatch``
3) on the card against the same steps run eagerly, at a small width: in
a process alone, and on one NCCL rank (route 'graph' in a group: no DDP
wrapper, the world's mesh and its gradients' all-reduce captured in the
graph) against the steps through the DDP wrapper. The file imports no JAX, so it runs where the card is:
``python -m pytest --noconftest -m gpu tests/test_torch_multi_step_gpu.py``
(the suite's conftest configures JAX); without a card its tests skip.
"""

import copy
import os

import pytest
import torch
import torch.distributed as dist

from soft_truncation_tpu_torch.configs.base import load_config, override
from soft_truncation_tpu_torch.data import make_preprocess_fn
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.parallel import (World, make_mesh, replicate,
                                                spatial)
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.train import (init_train_state,
                                             make_multi_train_step,
                                             make_train_step)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "soft_truncation_tpu_torch", "configs")
FAMILIES = {"flagship": os.path.join(CONFIGS, "vp", "CIFAR10",
                                     "ddpmpp_nll_st.py"),
            "uncsnpp": os.path.join(CONFIGS, "ve", "CIFAR10",
                                    "uncsnpp_st.py")}
# nf 16, two levels, dropout 0.1 (its masks drawn in the graph), no warmup
SMALL = {"data": dict(image_size=16, dequantization="uniform"),
         "model": dict(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                       attn_resolutions=(8,), init_scale=0.1),
         "training": dict(batch_size=8),
         "optim": dict(warmup=0),
         "tpu": dict(steps_per_dispatch=3)}
WINDOWS = (3, 3, 1)  # two full windows and a tail of one
REL_TOL = 1e-6  # max |graph - eager| of each tensor, of its max |eager|


def _state(config):
  return init_train_state(config, create_model(config, "cuda", seed=0))


def _tensors(state):
  opt = state.optimizer
  out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
  out.update({f"ema.{k}": v for k, v in state.ema.items()})
  out.update({f"mu.{i}": v for i, v in enumerate(opt.mu)})
  out.update({f"nu.{i}": v for i, v in enumerate(opt.nu)})
  return out


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_captured_window_equals_eager_steps(family):
  """Two full windows and a tail, each one replay of its width's graph,
  against the same steps eagerly from the same state and generator: the
  losses, parameters, EMA and Adam's moments within REL_TOL of each
  tensor's largest (bit for bit expected), the step counts, the
  generator's state; the graphs' replays, and UNCSN++'s fir2 launches and
  adjoints recorded at capture."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  config = load_config(FAMILIES[family])
  override(config, SMALL)
  eager_config = copy.deepcopy(config)
  eager_config.tpu.steps_per_dispatch = 1
  sde = get_sde(config)
  graphed, eager = _state(config), _state(config)
  windows = make_multi_train_step(config, sde)
  steps = make_multi_train_step(eager_config, sde)
  assert (windows.route, steps.route) == ("graph", "eager")
  gens = [torch.Generator("cuda").manual_seed(7) for _ in range(2)]
  data = torch.Generator().manual_seed(3)
  worst = 0.0
  for width in WINDOWS:
    batches = torch.randint(0, 256, (width, 8, 16, 16, 3), generator=data,
                            dtype=torch.uint8).pin_memory()
    got = windows(graphed, batches, gens[0])
    want = steps(eager, batches, gens[1])
    torch.cuda.synchronize()
    assert got.shape == want.shape == (width, 8)
    pairs = [("losses", got, want)] + [
        (k, v, _tensors(eager)[k]) for k, v in _tensors(graphed).items()]
    for name, g, w in pairs:
      err = (g.float() - w.float()).abs().max().item()
      scale = w.float().abs().max().item()
      worst = max(worst, err / max(scale, 1e-30))
      assert err <= REL_TOL * scale, (family, width, name, err, scale)
  print(f"{family}: worst max|graph - eager| / max|eager| = {worst:.3g}")
  assert graphed.step == eager.step == graphed.optimizer.count == 7
  assert torch.equal(gens[0].get_state(), gens[1].get_state())
  assert windows.replays == {3: 2, 1: 1}
  launches = windows.capture_launches
  if family == "uncsnpp":
    # one FIR up and one down per level change and pyramid step, and as
    # many adjoints, per captured step
    per_step = launches[1]
    assert per_step["fir_upsample2.launches"] > 0
    assert per_step["fir_downsample2.backward_launches"] > 0
    assert launches[3] == {k: 3 * v for k, v in per_step.items()}
  else:
    assert launches == {3: {}, 1: {}}


def _worst_rel_err(pairs, label):
  worst = 0.0
  for name, g, w in pairs:
    err = (g.float() - w.float()).abs().max().item()
    scale = w.float().abs().max().item()
    worst = max(worst, err / max(scale, 1e-30))
    assert err <= REL_TOL * scale, (label, name, err, scale)
  return worst


@pytest.mark.gpu
def test_captured_window_on_one_nccl_rank_equals_ddp_steps():
  """A world of one NCCL rank in this process: two windows of 3 of the
  tiny UNCSN++ on route 'graph' (no DDP wrapper: the world's mesh, the
  flattened gradients' all-reduce, fir2 and its adjoint in the graph)
  against 6 eager steps through the DDP wrapper from the same state and
  generator: within REL_TOL (bit for bit expected), the generators' states
  equal; the collectives recorded per capture, times the replays, one
  gradient all-reduce per step trained."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  config = load_config(FAMILIES["uncsnpp"])
  override(config, SMALL)
  sde = get_sde(config)
  dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    world = World(rank=0, size=1, launched=True)
    graphed, eager = _state(config), _state(config)
    windows = make_multi_train_step(config, sde)
    assert windows.route == "graph"
    graphed.mesh = make_mesh((), world)  # as run_lib._train gives it
    eager.replica = replicate(eager.model, world)
    step, preprocess = make_train_step(config, sde), make_preprocess_fn(config)
    gens = [torch.Generator("cuda").manual_seed(7) for _ in range(2)]
    data = torch.Generator().manual_seed(3)
    worst = 0.0
    spatial.calls.clear()
    for _ in range(2):
      batches = torch.randint(0, 256, (3, 8, 16, 16, 3), generator=data,
                              dtype=torch.uint8)
      got = windows(graphed, batches.pin_memory(), gens[0])
      want = torch.stack([step(eager, preprocess(b, gens[1]), gens[1])
                          for b in batches.cuda()])
      torch.cuda.synchronize()
      pairs = [("losses", got, want)] + [
          (k, v, _tensors(eager)[k]) for k, v in _tensors(graphed).items()]
      worst = max(worst, _worst_rel_err(pairs, "nccl_1"))
    print(f"one NCCL rank: worst max|graph - eager| / max|eager| = "
          f"{worst:.3g}")
    assert graphed.step == eager.step == 6
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert windows.replays == {3: 2}
    per_capture = windows.capture_collectives[3]
    assert per_capture == {"gradients": 3}
    assert {k: n * windows.replays[3] for k, n in per_capture.items()} == {
        "gradients": graphed.step}
    launches = windows.capture_launches[3]
    assert launches["fir_upsample2.launches"] > 0
    assert launches["fir_downsample2.backward_launches"] > 0
  finally:
    dist.destroy_process_group()
