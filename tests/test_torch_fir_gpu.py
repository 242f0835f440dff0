"""The bf16 ``fir2`` kernel (csrc/fir2_bf16.cu) on the card against its
plain version. The file imports no JAX, so it runs where the card is:
``python -m pytest --noconftest -m gpu tests/test_torch_fir_gpu.py`` (the
suite's conftest configures JAX); without a card its test skips.
"""

import pytest
import torch

from soft_truncation_tpu_torch.ops import fir, gn_conv
from soft_truncation_tpu_torch.ops.fir_sites import ulps

KERNELS = {"fir1331": [1., 3., 3., 1.], "box": [1., 1.],
           "len6": [1., 2., 4., 2., 1., 1.]}


@pytest.mark.gpu
def test_bf16_kernel_matches_plain_on_card():
  """fir2_bf16.cu's routes on the card against the plain version on the
  same bf16 input: bit for bit (the same f32 products and sums in the same
  order, an FMA only where its product is exact, one rounding), for taps
  whose H pass takes FMAs ([1, 3, 3, 1], [1, 1]) and taps whose does not
  (six), at a training step's shape (TMA), a served batch's, and C = 12 and
  3 (the direct route's 4- and 1-wide vectors), with each route counted on
  the wrappers."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  fir.reset_launch_counts()
  gen = torch.Generator("cuda").manual_seed(0)
  tma = 0
  for (n, h, c) in ((128, 16, 256), (8, 32, 128), (2, 9, 12), (2, 5, 3)):
    x = torch.randn(n, h, h, c, generator=gen, device="cuda").bfloat16()
    tma += fir.band_plan("up", 4, tuple(x.shape), (2 * h, 2 * h),
                         gn_conv._sms(x.device)).path == "tma"
    for k in KERNELS.values():
      for mode in ("up", "down"):
        for path in ("tma", "direct") if c % 8 == 0 else ("direct",):
          got, taken = fir._launch(x, tuple(k), 1.0, mode, None, x.device,
                                   path)
          want = fir._fir2_plain(x, k, 1.0, mode)
          assert taken == path and ulps(got, want).max() == 0, (
              n, h, c, k, mode, path)
    with torch.inference_mode():
      fir.fir_upsample2(x, KERNELS["fir1331"])
  routes = (fir.fir_upsample2.bf16_tma_launches,
            fir.fir_upsample2.bf16_direct_launches)
  assert sum(routes) == fir.fir_upsample2.bf16_launches == 4
  assert routes[0] == tma >= 1  # the route each plan names


@pytest.mark.gpu
def test_bf16_tma_route_launches_from_a_fresh_thread():
  """The TMA route encodes its tensor map on the host at every call, a
  driver call that needs a context current to the calling thread: a thread
  that has launched nothing yet, as a server's handler thread, gets the
  same result as the main thread."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the fir2 kernel has no CPU mode")
  import threading
  x = torch.randn(128, 16, 16, 256, device="cuda").bfloat16()
  k = (1.0, 3.0, 3.0, 1.0)
  want, taken = fir._launch(x, k, 1.0, "up", None, x.device, "tma")
  got = []
  thread = threading.Thread(target=lambda: got.append(
      fir._launch(x, k, 1.0, "up", None, x.device, "tma")))
  thread.start()
  thread.join(timeout=60)
  assert not thread.is_alive() and got and taken == got[0][1] == "tma"
  torch.cuda.synchronize()
  assert torch.equal(got[0][0], want)

