"""Activation checkpointing of NCSN++'s res-blocks (``config.tpu.remat``,
soft_truncation_tpu_torch/models/ncsnpp.py) on the CPU.

A train step with remat, under either policy, must be the step without
it: the same losses, gradients and parameters (rtol 1e-6), and the dropout
generator left where the step without remat leaves it, though the
recompute draws its masks again from that generator. On the tiny flagship
(dropout 0.1) and the tiny UNCSN++ (FIR resamples, whose recompute runs
the resample again). Then what each policy recomputes.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from soft_truncation_tpu_torch.configs.base import load_config, override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.ops import fir
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.train import init_train_state, make_train_step

import torch_tiny

BATCH = 4
FAMILIES = {torch_tiny.FLAGSHIP: torch_tiny.PORT_FLAGSHIP,
            torch_tiny.UNCSNPP: torch_tiny.PORT_UNCSNPP}
POLICIES = (None, "full", "conv_outputs")


def _config(family, policy):
  config = load_config(FAMILIES[family])
  override(config, torch_tiny.TINY)
  config.optim.warmup = 0  # the first update moves the parameters
  config.training.batch_size = BATCH
  config.tpu.remat = policy is not None
  config.tpu.remat_policy = policy or "full"
  assert config.model.dropout == 0.1
  return config


def _step(family, policy):
  """One train step from seeded weights, batch and generator: the losses,
  the gradients (Adam's first moment over 1 - b1), the parameters after
  the update and the generator's state."""
  config = _config(family, policy)
  model = create_model(config, "cpu", seed=1).train()
  state = init_train_state(config, model)
  gen = torch.Generator().manual_seed(3)
  batch = torch.rand((BATCH,) + torch_tiny.SHAPE[1:],
                     generator=torch.Generator().manual_seed(0))
  losses = make_train_step(config, get_sde(config))(state, batch, gen)
  grads = [mu / (1.0 - config.optim.beta1) for mu in state.optimizer.mu]
  return (losses, grads, [p.detach().clone() for p in model.parameters()],
          gen.get_state())


@pytest.fixture(scope="module")
def steps():
  return {(family, policy): _step(family, policy)
          for family in FAMILIES for policy in POLICIES}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("policy", ["full", "conv_outputs"])
def test_remat_step_is_the_plain_step(steps, family, policy):
  want_losses, want_grads, want_params, want_gen = steps[(family, None)]
  losses, grads, params, gen = steps[(family, policy)]
  torch.testing.assert_close(losses, want_losses, rtol=1e-6, atol=0)
  for g, w in zip(grads, want_grads):
    torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max())
  for p, w in zip(params, want_params):
    torch.testing.assert_close(p, w, rtol=1e-6, atol=1e-6 * w.abs().max())
  assert torch.equal(gen, want_gen)
  assert any(g.abs().max() > 0 for g in grads[:-2])


class _CountConvolutions(TorchDispatchMode):

  def __init__(self):
    super().__init__()
    self.convolutions = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func is torch.ops.aten.convolution.default:
      self.convolutions += 1
    return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_what_each_policy_recomputes(policy, monkeypatch):
  """In the backward: 'full' recomputes the convolutions, 'conv_outputs'
  none of them (they are kept); both run each block's FIR resamples again,
  through ``ops.fir``'s resample, and no remat recomputes nothing."""
  config = _config(torch_tiny.UNCSNPP, policy)
  model = create_model(config, "cpu", seed=1).train()
  resamples = []
  plain = fir._resample

  def counted(*args, **kwargs):
    resamples.append(args[5])  # the tally: 'forward', 'backward' or 'jvp'
    return plain(*args, **kwargs)

  monkeypatch.setattr(fir, "_resample", counted)
  x = torch.rand(torch_tiny.SHAPE, generator=torch.Generator().manual_seed(0))
  labels = torch.tensor([0.05, 20.0])
  out = model(x, labels, train=True,
              generator=torch.Generator().manual_seed(1))
  forward = resamples.count("forward")
  assert forward == len(model.fir_sites()) > 0
  counter = _CountConvolutions()
  with counter:
    out.square().sum().backward()
  recomputed = resamples.count("forward") - forward
  block_fir = sum(1 for name, m in model.named_modules()
                  if name.startswith(("down_", "up_")) and hasattr(
                      m, "last_fir_sites") and hasattr(m, "conv0")
                  for _ in m.last_fir_sites)
  if policy is None:
    assert counter.convolutions == 0 and recomputed == 0
  elif policy == "full":
    assert counter.convolutions > 0 and recomputed == block_fir > 0
  else:
    assert counter.convolutions == 0 and recomputed == block_fir > 0
