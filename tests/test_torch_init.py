"""Every layer of the port with parameters is usable once constructed: no
parameter holds uninitialised memory, whatever state torch's global random
generator is in; and a model built from a seed keeps the weights it had
before its layers initialised themselves (the model-level
``reset_parameters(generator)`` walk still sets every weight)."""

import hashlib
import math

import pytest
import torch

from soft_truncation_tpu_torch.configs.base import load_config, override
from soft_truncation_tpu_torch.models import (create_model, layers, layerspp,
                                              logsnr, normalization as zoo)
from soft_truncation_tpu_torch.ops import quant

import torch_tiny

LAYERS = {
    "DDPMConv": lambda: layers.DDPMConv(4, 6, 3),
    "DDPMConv_zero_init": lambda: layers.DDPMConv(4, 6, 3, init_scale=0.0),
    "DDPMConv_stride2": lambda: layers.DDPMConv(4, 6, 3, stride=2),
    "QConv": lambda: layers.ddpm_conv(4, 6, 3, act_quant="float8_e4m3"),
    "Conv2d": lambda: layers.Conv2d(4, 6, 3, dilation=2),
    "Conv2d_lecun": lambda: layers.Conv2d(4, 6, 3, lecun=True),
    "NCSNConv": lambda: layers.NCSNConv(4, 6, 3, use_bias=False),
    "Dense": lambda: layers.Dense(5, 7),
    "NIN": lambda: layers.NIN(5, 7),
    "GroupNorm": lambda: layers.GroupNorm(2, 8),
    "GaussianFourierProjection":
        lambda: layerspp.GaussianFourierProjection(16, 16.0),
    "ConvResample": lambda: layerspp.ConvResample("up", 4, 6),
    "PosDense": lambda: logsnr.PosDense(3, 5),
    "LogSNR": lambda: logsnr.LogSNR(mid_dim=8),
    "VarianceNorm2d": lambda: zoo.VarianceNorm2d(6),
    "InstanceNorm2dPlus": lambda: zoo.InstanceNorm2dPlus(6),
    "ConditionalBatchNorm2d": lambda: zoo.ConditionalBatchNorm2d(6, 3),
    "ConditionalInstanceNorm2d":
        lambda: zoo.ConditionalInstanceNorm2d(6, 3, False),
    "ConditionalNoneNorm2d": lambda: zoo.ConditionalNoneNorm2d(6, 3, True),
    "ConditionalVarianceNorm2d": lambda: zoo.ConditionalVarianceNorm2d(6, 3),
    "ConditionalInstanceNorm2dPlus":
        lambda: zoo.ConditionalInstanceNorm2dPlus(6, 3),
}
# the global seeds include those under which a DDPMConv built alone held
# NaN before its constructor initialised it
SEEDS = (0, 4, 9, 10, 24, 39, 123)


def _poison_allocator():
  """Free blocks full of NaN, which a later ``torch.empty`` may reuse."""
  for n in (16, 64, 216, 1024):
    t = torch.full((n,), math.nan)
    del t


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_parameters_are_finite_once_constructed(name):
  for seed in SEEDS:
    torch.manual_seed(seed)
    _poison_allocator()
    module = LAYERS[name]()
    for key, p in module.named_parameters():
      assert torch.isfinite(p).all(), f"{name}.{key} under seed {seed}"


def test_a_layer_draws_its_init_from_the_global_generator():
  """With no generator a layer's init follows torch's global one, as a
  ``torch.nn`` layer's does."""
  torch.manual_seed(5)
  a = layers.DDPMConv(4, 6, 3).weight.detach().clone()
  torch.manual_seed(5)
  b = layers.DDPMConv(4, 6, 3).weight.detach()
  torch.manual_seed(6)
  c = layers.DDPMConv(4, 6, 3).weight.detach()
  torch.testing.assert_close(a, b, rtol=0, atol=0)
  assert not torch.equal(a, c)
  assert isinstance(layers.ddpm_conv(4, 6, 3, act_quant="float8_e4m3"),
                    quant.QConv)


# sha256 of (name, float32 bytes) over the sorted state_dict of
# create_model(tiny config, seed=3), as the models were built before their
# layers initialised themselves
DIGESTS = {
    "vp/CIFAR10/ddpmpp_nll_st.py":
        "7e9064063580649fb7d1e9d0b6d42786e1f7db16cae963d393a1b791877900cc",
    "ve/CIFAR10/uncsnpp_st.py":
        "fda982469dc913e0e5e46f4b35a4022dbb66089b7fc189ca4a62faad42039a74",
    "vp/CIFAR10/ddpmpp_nll_st_deepest.py":
        "73748fbf40893b5e38dd1d77fba2edf66c82219a56e9f94a7320eb91fa400242",
}


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_seeded_model_weights_are_unchanged(rel):
  config = load_config(f"{torch_tiny.PORT_CONFIGS}/{rel}")
  override(config, torch_tiny.TINY)
  torch.manual_seed(123)
  model = create_model(config, "cpu", seed=3)
  h = hashlib.sha256()
  for key, value in sorted(model.state_dict().items()):
    h.update(key.encode())
    h.update(value.detach().contiguous().numpy().tobytes())
  assert h.hexdigest() == DIGESTS[rel]
