"""Shared set-up of the port's parity tests: a tiny flagship-shaped model
built once in JAX and carried into the port through the params npz.

Tiny = the flagship config (DDPM++ BigGAN blocks, positional embedding,
attention, fir=False) cut to nf 16, ch_mult (1, 2), one res-block, 16x16,
attention at 8x8, with init_scale 0.1 so that every conv carries signal.
"""

import os
import tempfile

import jax
import numpy as np

from soft_truncation_tpu.configs.vp.CIFAR10 import ddpmpp_nll_st as jax_flagship
from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.serve.export import save_params_npz
from soft_truncation_tpu_torch.configs.base import load_config, override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.utils.jax_params import (from_jax_params,
                                                        load_params_npz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FLAGSHIP = os.path.join(REPO, "soft_truncation_tpu_torch", "configs",
                             "vp", "CIFAR10", "ddpmpp_nll_st.py")
TINY = {
    "data": dict(image_size=16),
    "model": dict(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), init_scale=0.1),
}
SHAPE = (2, 16, 16, 3)  # NHWC sample batch of the tiny model
# full width, with signal in every conv (the flagship's 0.0 makes each
# conv1 and out_conv about 1e-10)
FULL = {"model": dict(init_scale=0.1)}


def configs(changes=TINY):
  """(JAX config, port config) of the flagship with ``changes`` applied."""
  jc, pc = jax_flagship.get_config(), load_config(PORT_FLAGSHIP)
  jax_override(jc, changes)
  override(pc, changes)
  return jc, pc


def via_npz(params):
  """JAX params -> save_params_npz -> the port's loader and converter."""
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "params.npz")
    save_params_npz(params, path)
    tree = load_params_npz(path)
  return tree, from_jax_params(tree)


def build(changes=TINY, batch=2, seed=0):
  """JAX model + params and the port model carrying the same weights."""
  jc, pc = configs(changes)
  size = jc.data.image_size
  x = np.zeros((batch, size, size, 3), np.float32)
  t = np.full((batch,), 500.0, np.float32)
  jmodel = jax_create_model(jc)
  params = jax.jit(lambda k: jmodel.init({"params": k}, x, t, train=False))(
      jax.random.PRNGKey(seed))["params"]
  pmodel = create_model(pc, "cpu")
  pmodel.load_state_dict(via_npz(params)[1])
  return jc, pc, jmodel, params, pmodel


def jax_forward(jmodel, params, x, t):
  """The JAX eval forward, jitted (op-by-op dispatch is slow here)."""
  fn = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t, train=False))
  return np.asarray(fn(params, x, t))
