"""The gn_silu_conv3x3 kernels that feed their weights by TMA on the card:
the f32 tangent (csrc/gn_silu_conv3x3_jvp.cu) against its plain version,
and the tensor maps of it and of the bf16 kernel (csrc/
gn_silu_conv3x3_bf16.cu) encoded from a thread that has launched nothing.
The file imports no JAX, so it runs where the card is: ``python -m pytest
--noconftest -m gpu tests/test_torch_gn_conv_gpu.py`` (the suite's conftest
configures JAX); without a card its tests skip.
"""

import threading

import pytest
import torch

from soft_truncation_tpu_torch.ops import gn_conv

REL_TOL = 1e-4  # chip_smoke.py's KERNEL_REL_TOL: reordered f32 sums


def _tangent_args(n, h, w, c, o, groups, dtype=torch.float32, seed=0):
  gen = torch.Generator("cuda").manual_seed(seed)
  x, dx = (torch.randn(n, h, w, c, generator=gen, device="cuda").to(dtype)
           for _ in range(2))
  gamma, beta = (torch.randn(c, generator=gen, device="cuda")
                 for _ in range(2))
  wgt = (torch.randn(3, 3, c, o, generator=gen, device="cuda")
         / (9 * c) ** 0.5).to(dtype)
  (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
      lambda v: gn_conv.gn_stats(v, groups), (x,), (dx,))
  return (x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, groups)


def _needs_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the gn_silu_conv3x3 kernels have no CPU "
                "mode")


@pytest.fixture(autouse=True)
def _no_tf32():
  """The plain versions' convolutions in full f32 (cuDNN takes TF32 by
  default), as chip_smoke.py runs them."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  yield
  torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
      saved)


@pytest.mark.gpu
def test_f32_tangent_matches_plain_on_card():
  """The f32 tangent within 1e-4 of max |plain| and the same bits twice
  (the cluster sums in rank order), each launch counted: clusters of 8 at
  8x8 and 4x4, of 2 at 16x16 with 256-wide blocks, none at 32x32, tiles
  that straddle images with C = 36 (a padded chunk) and O = 20, a
  100-pixel row in two segments, O past 256 in 128-wide blocks."""
  _needs_card()
  gn_conv.reset_launch_counts()
  cases = [(8, 8, 8, 256, 256, 32), (8, 4, 4, 512, 256, 32),
           (8, 16, 16, 256, 256, 32), (8, 32, 32, 128, 128, 32),
           (3, 5, 7, 36, 20, 12), (2, 3, 100, 24, 40, 4),
           (1, 2, 128, 16, 300, 4)]
  for n, h, w, c, o, groups in cases:
    args = _tangent_args(n, h, w, c, o, groups)
    with torch.inference_mode():
      got = gn_conv.gn_silu_conv3x3_jvp(*args)
      again = gn_conv.gn_silu_conv3x3_jvp(*args)
      want = gn_conv.gn_silu_conv3x3_jvp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), (n, h, w, c, o)
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), (n, h, w, c, o, err)
  assert gn_conv.gn_silu_conv3x3.jvp_launches == 2 * len(cases)
  assert gn_conv.gn_silu_conv3x3.bf16_jvp_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_maps_encode_from_a_fresh_thread(dtype):
  """A thread that has launched nothing (a server's handler thread) encodes
  the weights' tensor maps (hopper.cuh binds the device's primary context)
  and launches: the bf16 primal and the f32 tangent give the main thread's
  bits, the main thread's maps made for another copy of the operand."""
  _needs_card()
  n, h, w, c, o, groups = 8, 8, 8, 256, 256, 32
  args = _tangent_args(n, h, w, c, o, groups, dtype)
  x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, _ = args
  b = torch.zeros(o, device="cuda", dtype=dtype)
  if dtype == torch.bfloat16:
    make = gn_conv.weight_operand

    def call(split):
      return gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wgt, b,
                                     groups, split)
  else:
    make = gn_conv.jvp_weight_operand

    def call(split):
      return gn_conv.gn_silu_conv3x3_jvp(*args, w_split=split)

  theirs, ours = make(wgt), tuple(t.clone() for t in make(wgt))
  gn_conv._tensor_map.cache_clear()
  got, failed = [], []

  def fresh():
    try:
      with torch.inference_mode():
        got.append(call(theirs))
      torch.cuda.synchronize()
    except Exception as e:  # reported below, in the main thread
      failed.append(e)

  thread = threading.Thread(target=fresh)
  thread.start()
  thread.join(timeout=120)
  assert not thread.is_alive() and not failed, failed
  with torch.inference_mode():
    want = call(ours)
  torch.cuda.synchronize()
  assert gn_conv._tensor_map.cache_info().currsize == 2 * len(ours)
  assert torch.equal(got[0], want)
