"""The port's fused GroupNorm->SiLU->conv3x3 (soft_truncation_tpu_torch/ops/
gn_conv.py) against the JAX package's plain chain, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
gn_silu_conv3x3_plain there. Here the plain version, which the CPU path of
the port takes, is held against the JAX reference (gn_stats +
gn_silu_conv3x3_reference; not interpret-mode Pallas, which deadlocks on
this suite's CPU, see test_gn_conv_fused.py), in f32 at rtol=atol=1e-5:
the same f32 arithmetic summed in another order over K <= 9*128 terms.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.ops.pallas import gn_conv as jax_gn_conv
from soft_truncation_tpu_torch.ops import gn_conv

CASES = [(2, 8, 8, 16, 16, 4), (2, 8, 8, 32, 48, 8), (1, 32, 32, 128, 128, 32)]


def _inputs(n, h, w, c, o, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((n, h, w, c)) * 2.0).astype(np.float32)
  gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
  beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
  wgt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
  b = rng.standard_normal(o).astype(np.float32)
  return x, gamma, beta, wgt, b


@pytest.mark.parametrize("n,h,w,c,o,groups", CASES)
def test_plain_matches_jax_reference(n, h, w, c, o, groups):
  x, gamma, beta, wgt, b = _inputs(n, h, w, c, o)
  want = jax_gn_conv.gn_silu_conv3x3_reference(
      jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
      jnp.asarray(wgt), jnp.asarray(b), groups)
  jmean, jrsqrt = jax_gn_conv.gn_stats(jnp.asarray(x), groups)

  tx = torch.from_numpy(x)
  mean, rsqrt = gn_conv.gn_stats(tx, groups)
  np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(rsqrt.numpy(), np.asarray(jrsqrt), rtol=1e-5,
                             atol=1e-5)
  got = gn_conv.gn_silu_conv3x3_plain(
      tx, mean, rsqrt, torch.from_numpy(gamma), torch.from_numpy(beta),
      torch.from_numpy(wgt), torch.from_numpy(b), groups)
  assert got.shape == (n, h, w, o) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


def test_cpu_wrapper_takes_plain_version_without_launching():
  x, gamma, beta, wgt, b = (torch.from_numpy(a)
                            for a in _inputs(2, 8, 8, 32, 48, seed=1))
  mean, rsqrt = gn_conv.gn_stats(x, 8)
  before = gn_conv.gn_silu_conv3x3.launches
  got = gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wgt, b, 8)
  want = gn_conv.gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, wgt, b, 8)
  assert torch.equal(got, want)
  assert gn_conv.gn_silu_conv3x3.launches == before


@pytest.mark.parametrize("fault", ["groups", "weight_shape", "needs_grad"])
def test_wrapper_refuses_what_it_does_not_take(fault):
  x, gamma, beta, wgt, b = (torch.from_numpy(a)
                            for a in _inputs(1, 4, 4, 16, 16, seed=2))
  mean, rsqrt = gn_conv.gn_stats(x, 4)
  groups = 4
  if fault == "groups":
    groups = 3
  elif fault == "weight_shape":
    wgt = wgt[:, :, :8]
  else:
    wgt.requires_grad_(True)
  with pytest.raises((ValueError, RuntimeError)):
    gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wgt, b, groups)


def test_package_imports_without_nvcc_or_card():
  """Importing every module of the port builds nothing and needs no nvcc."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PATH=os.path.dirname(sys.executable),
             CUDA_HOME=os.path.join(repo, "no-cuda-here"),
             CUDA_VISIBLE_DEVICES="")
  code = ("import soft_truncation_tpu_torch.serve.server\n"
          "from soft_truncation_tpu_torch.ops import _build\n"
          "assert _build.load_library.cache_info().currsize == 0\n"
          "print('imported')\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr[-2000:]
  assert "imported" in proc.stdout
