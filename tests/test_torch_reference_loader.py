"""The port's reference-checkpoint loader (soft_truncation_tpu_torch/utils/
torch_port.py) on the reference goldens: a reference state_dict in, the
port model's state_dict out, and the port's forward equal to the
reference's golden output at the JAX package's bar (rtol 2e-3, atol 2e-4,
tests/test_ncsnpp_parity.py). The loader's mapping is a copy of the JAX
package's, held here to it; and a ``.pth`` with an EMA shadow."""

import os

import numpy as np
import pytest
import torch

from soft_truncation_tpu.utils import torch_port as jax_torch_port
from soft_truncation_tpu_torch.configs.base import default_config, override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.utils import torch_port
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

import torch_tiny  # noqa: F401  (caps torch's threads)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_ncsnpp_parity.py's cases
CASES = {
    "uncsnpp": dict(fir=True, progressive_input="residual",
                    scale_by_sigma=True),
    "progressive": dict(progressive="output_skip",
                        progressive_input="input_skip",
                        progressive_combine="cat", fourier_feature=True,
                        fir=True),
    "ddpmpp": dict(resblock_type="ddpm", embedding_type="positional"),
}


def _config(**model_overrides):
  """tests/test_ncsnpp_parity.py::tiny_config, for the port."""
  config = default_config("cifar10")
  model = dict(
      name="ncsnpp", scale_by_sigma=False, ema_rate=0.999,
      normalization="GroupNorm", nonlinearity="swish", nf=16,
      ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
      resamp_with_conv=True, conditional=True, fir=False,
      fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type="biggan",
      progressive="none", progressive_input="none",
      progressive_combine="sum", init_scale=0.0, embedding_type="fourier",
      fourier_scale=16, conv_size=3)
  model.update(model_overrides)
  override(config, {"model": model,
                    "data": dict(image_size=16, centered=True)})
  return config


def _golden(name):
  gold = np.load(os.path.join(GOLD_DIR, f"ncsnpp_golden_{name}.npz"))
  sd = {k[4:]: torch.from_numpy(gold[k]) for k in gold.files
        if k.startswith("sd::")}
  return gold, sd


@pytest.mark.parametrize("name", sorted(CASES))
def test_loaded_reference_reproduces_its_golden_forward(name):
  gold, sd = _golden(name)
  config = _config(**CASES[name])
  model = create_model(config, "cpu")
  model.load_state_dict(torch_port.load_reference_checkpoint(sd, config))
  x = torch.from_numpy(np.ascontiguousarray(
      np.transpose(gold["x"], (0, 2, 3, 1))))
  with torch.no_grad():
    got = model(x, torch.from_numpy(gold["t"])).numpy()
  want = np.transpose(gold["y"], (0, 2, 3, 1))
  np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_mapping_is_the_jax_packages(name):
  """The copy maps every golden the same way as the JAX package's, through
  ``from_jax_params``: the same module order and the same arrays."""
  _, sd = _golden(name)
  config = _config(**CASES[name])
  assert (torch_port.ncsnpp_module_order(config)
          == jax_torch_port.ncsnpp_module_order(config))
  want = from_jax_params(jax_torch_port.port_ncsnpp_state_dict(
      {k: v.numpy() for k, v in sd.items()}, config))
  got = torch_port.load_reference_checkpoint(sd, config)
  assert got.keys() == want.keys()
  for k in want:
    assert torch.equal(got[k], want[k]), k


def test_a_pth_with_its_ema_shadow(tmp_path):
  """A reference ``.pth``: the model's weights, or with ``ema=True`` the
  shadow's (+1 here), the frozen Fourier W kept; no shadow refuses."""
  _, sd = _golden("uncsnpp")
  config = _config(**CASES["uncsnpp"])
  shadow = [v + 1.0 for k, v in sd.items()
            if not k.endswith(("sigmas", "all_modules.0.W"))]
  path = str(tmp_path / "checkpoint.pth")
  torch.save({"model": sd, "optimizer": {}, "step": 12,
              "ema": {"decay": 0.999, "num_updates": 7,
                      "shadow_params": shadow}}, path)
  params = torch_port.load_reference_checkpoint(path, config)
  ema = torch_port.load_reference_checkpoint(path, config, ema=True)
  torch.testing.assert_close(ema["mid_res0.conv0.weight"],
                             params["mid_res0.conv0.weight"] + 1.0)
  assert torch.equal(ema["fourier_emb.W"], params["fourier_emb.W"])
  create_model(config, "cpu").load_state_dict(ema)
  with pytest.raises(ValueError, match="no EMA"):
    torch_port.load_reference_checkpoint({"model": sd}, config, ema=True)
