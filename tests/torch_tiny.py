"""Shared set-up of the port's parity tests: tiny models whose weights are
drawn by the port, set into the JAX model's parameter tree (its structure
from ``jax.eval_shape`` of the init: no XLA compile of the init) and carried
back into the port through the params npz.

Tiny = a config cut to nf 16, ch_mult (1, 2), one res-block, 16x16,
attention at 8x8, with init_scale 0.1 so that every conv carries signal:
the flagship (DDPM++ BigGAN blocks, positional embedding, fir=False) by
default, or UNCSN++ (``UNCSNPP``: FIR resampling, residual input pyramid,
Fourier embedding, scale_by_sigma, reciprocal VE SDE).

Importing this module caps torch's intra-op threads at 2: the port's tests
run tiny shapes beside the rest of the suite's workers, and torch's default
of one thread per core would crowd them.
"""

import os
import tempfile

import jax
import numpy as np
import torch

from soft_truncation_tpu.configs.ve.CIFAR10 import uncsnpp_st as jax_uncsnpp
from soft_truncation_tpu.configs.vp.CIFAR10 import ddpmpp_nll_st as jax_flagship
from soft_truncation_tpu.configs.base import override as jax_override
from soft_truncation_tpu.models import create_model as jax_create_model
from soft_truncation_tpu.serve.export import save_params_npz
from soft_truncation_tpu_torch.configs.base import load_config, override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.utils.jax_params import (from_jax_params,
                                                        load_params_npz)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = os.path.join(REPO, "soft_truncation_tpu_torch", "configs")
PORT_FLAGSHIP = os.path.join(PORT_CONFIGS, "vp", "CIFAR10", "ddpmpp_nll_st.py")
PORT_UNCSNPP = os.path.join(PORT_CONFIGS, "ve", "CIFAR10", "uncsnpp_st.py")
FLAGSHIP, UNCSNPP = "flagship", "uncsnpp"
_FAMILIES = {FLAGSHIP: (jax_flagship, PORT_FLAGSHIP),
             UNCSNPP: (jax_uncsnpp, PORT_UNCSNPP)}
TINY = {
    "data": dict(image_size=16),
    "model": dict(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), init_scale=0.1),
}
SHAPE = (2, 16, 16, 3)  # NHWC sample batch of the tiny model
# smaller still, for the likelihood's tests: JAX compiles the network's jvp
# up to 8 times in one dopri5 program
SMALL = {
    "data": dict(image_size=8),
    "model": dict(nf=8, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(4,), init_scale=0.1),
}
# full width, with signal in every conv (the flagship's 0.0 makes each
# conv1 and out_conv about 1e-10)
FULL = {"model": dict(init_scale=0.1)}


def configs(changes=TINY, family=FLAGSHIP):
  """(JAX config, port config) of ``family`` with ``changes`` applied."""
  jax_module, port_path = _FAMILIES[family]
  jc, pc = jax_module.get_config(), load_config(port_path)
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


def to_jax_params(state_dict, template):
  """A port state_dict as a Flax parameter tree shaped like ``template``
  (the inverse of ``from_jax_params``)."""

  def leaf(path, spec):
    *mods, name = [p.key for p in path]
    a = state_dict[".".join(mods + [{"kernel": "weight", "scale": "weight"}
                                    .get(name, name)])].numpy()
    if name == "kernel":
      a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    assert a.shape == spec.shape, (path, a.shape, spec.shape)
    return np.ascontiguousarray(a, dtype=np.float32)

  return jax.tree_util.tree_map_with_path(leaf, template)


def build(changes=TINY, batch=2, seed=0, family=FLAGSHIP):
  """JAX model + params and the port model carrying the same weights
  (drawn by the port from ``seed``)."""
  jc, pc = configs(changes, family)
  size = jc.data.image_size
  x = np.zeros((batch, size, size, 3), np.float32)
  t = np.full((batch,), 0.5, np.float32)
  jmodel = jax_create_model(jc)
  template = jax.eval_shape(
      lambda k: jmodel.init({"params": k}, x, t, train=False),
      jax.random.PRNGKey(0))["params"]
  params = to_jax_params(create_model(pc, "cpu", seed=seed).state_dict(),
                         template)
  pmodel = create_model(pc, "cpu")
  pmodel.load_state_dict(via_npz(params)[1])
  return jc, pc, jmodel, params, pmodel


def jax_forward(jmodel, params, x, t):
  """The JAX eval forward, jitted (op-by-op dispatch is slow here)."""
  fn = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t, train=False))
  return np.asarray(fn(params, x, t))
