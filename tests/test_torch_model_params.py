"""The port's schedule tables (soft_truncation_tpu_torch/models/params.py)
against the JAX package's, bit for bit: the same float64 numpy formulas."""

import numpy as np
import pytest

from soft_truncation_tpu.models import get_ddpm_params as jax_ddpm_params
from soft_truncation_tpu.models import get_sigmas as jax_sigmas
from soft_truncation_tpu_torch.models import get_ddpm_params, get_sigmas

import torch_tiny

# the flagship as published, and NCSNv2's CIFAR-10 noise levels (the
# public yang-song/score_sde_pytorch configs/ve/ncsnv2/cifar10.py) over it
CASES = {"flagship": {},
         "ncsnv2": {"model": dict(sigma_min=0.01, sigma_max=50.0,
                                  num_scales=232)}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_tables_match_jax(case):
  jc, pc = torch_tiny.configs(CASES[case])
  want, got = jax_sigmas(jc), get_sigmas(pc)
  assert got.dtype == want.dtype == np.float64
  assert got.shape == (pc.model.num_scales,)
  np.testing.assert_array_equal(got, want)
  want, got = jax_ddpm_params(jc), get_ddpm_params(pc)
  assert set(got) == set(want)
  for key, value in want.items():
    np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value),
                                  err_msg=key)
    assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
