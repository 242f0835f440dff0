"""The port's res-block dropout (soft_truncation_tpu_torch/models/dropout.py)
against the JAX package's (soft_truncation_tpu/models/dropout.py), on the
CPU.

JAX's default ``config.tpu.dropout_bits = 0`` resolves to 8 under the
default threefry generator: every NCSN++ res-block then drops with the
keep rate quantized to 1/256 and scales by its inverse. The two packages'
generators differ, so both are handed the same uint32 words (JAX's
``random.bits`` and the port's draw replaced) and the outputs must agree
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_truncation_tpu.models.dropout import Dropout as JaxDropout
from soft_truncation_tpu_torch.configs.base import (default_config,
                                                    tpu_dropout_bits)
from soft_truncation_tpu_torch.models import dropout as port_dropout


def _given_words(monkeypatch, words):
  """Both packages draw ``words`` (uint32) instead of their generators'."""
  asked = []

  def jax_bits(key, shape, dtype):
    assert tuple(shape) == words.shape and dtype == jnp.uint32
    return jnp.asarray(words)

  def port_draw(draw, *shard):
    def given(kind, shape, high=None):
      asked.append(tuple(shape))
      return torch.from_numpy(words.astype(np.int64))
    return given

  monkeypatch.setattr(jax.random, "bits", jax_bits)
  monkeypatch.setattr(port_dropout, "sharded_draw", port_draw)
  return asked


@pytest.mark.parametrize("bits,rate", [(8, 0.1), (16, 0.1), (8, 0.37)])
def test_packed_dropout_matches_flax_given_the_same_words(monkeypatch, bits,
                                                          rate):
  """The lanes, the threshold round(keep * 2^bits), the mask and x / q,
  bit for bit Flax's Dropout(bits) given the same words."""
  rng = np.random.default_rng(bits)
  x = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
  pack = 32 // bits
  words = rng.integers(0, 1 << 32, (2, 4, 3, 8 // pack), dtype=np.uint64)
  words = words.astype(np.uint32)
  asked = _given_words(monkeypatch, words)
  want = np.asarray(JaxDropout(rate, bits=bits).apply(
      {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
  got = port_dropout.Dropout(rate, bits)(torch.from_numpy(x), True,
                                         torch.Generator())
  assert asked == [words.shape]
  np.testing.assert_array_equal(got.numpy(), want)
  span = 1 << bits
  q = round((1 - rate) * span) / span
  kept = want != 0
  assert 0 < kept.mean() < 1
  np.testing.assert_array_equal(want[kept], x[kept] / np.float32(q))


def test_default_rate_keeps_230_of_256_and_scales_by_their_inverse():
  """At rate 0.1 and 8 bits: lane < 230 is kept, scaled by 256 / 230."""
  lanes = torch.arange(256).reshape(1, 1, 1, 256)
  x = torch.ones(1, 1, 1, 256)
  words = np.zeros((1, 1, 1, 64), np.uint32)
  for i in range(4):
    words |= (lanes.numpy()[..., i::4].astype(np.uint32) << (8 * i))
  drop = port_dropout.Dropout(0.1, 8)
  gen = torch.Generator()
  with pytest.MonkeyPatch.context() as mp:
    _given_words(mp, words)
    got = drop(x, True, gen)
  assert torch.equal(got != 0, lanes < 230)
  assert torch.equal(got[got != 0], torch.full((230,), 1 / (230 / 256)))


def test_all_kept_odd_channels_and_32_bits_take_their_paths(monkeypatch):
  """A rate under half a step of 1/256 keeps every element (x itself);
  channels that do not split into lanes, and 32 bits, draw the Bernoulli
  mask of flax.linen.Dropout and scale by 1 / keep."""
  x = torch.randn(2, 3, 3, 6, generator=torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(1)
  x8 = torch.randn(2, 3, 3, 8, generator=gen)
  assert port_dropout.Dropout(0.001, 8)(x8, True, gen) is x8
  masks = []

  def keep_mask(shape, keep, generator, device):
    masks.append(keep)
    return torch.arange(int(np.prod(shape))).reshape(shape) % 3 > 0

  monkeypatch.setattr(port_dropout, "keep_mask", keep_mask)
  for bits in (8, 32):
    got = port_dropout.Dropout(0.25, bits)(x, True, gen)
    mask = keep_mask(x.shape, 0.75, None, None)
    assert torch.equal(got, torch.where(mask, x / 0.75, torch.zeros_like(x)))
  assert masks == [0.75] * 4


@pytest.mark.parametrize("tpu,want", [
    ({}, 8), ({"rng_impl": "rbg"}, 32), ({"rng_impl": "unsafe_rbg"}, 32),
    ({"dropout_bits": "auto"}, 8), ({"dropout_bits": 16}, 16),
    ({"dropout_bits": 32, "rng_impl": "threefry2x32"}, 32), (None, 32)])
def test_dropout_bits_resolve_as_jax_resolves_them(tpu, want):
  """0 (the default) is 8 under threefry and 32 under rbg; a value as
  given; no tpu section, 32. The NCSN++ res-blocks take the result."""
  from soft_truncation_tpu_torch.models.ncsnpp import NCSNpp
  config = default_config("cifar10")
  assert config.tpu.dropout_bits == 0
  assert config.tpu.rng_impl == "threefry2x32"
  if tpu is None:
    del config["tpu"]
  else:
    config.tpu.update(tpu)
  assert tpu_dropout_bits(config) == want
  config.model.update(nf=16, ch_mult=(1,), num_res_blocks=1,
                      attn_resolutions=(), scale_by_sigma=False,
                      centered=True, conditional=True, fir=False,
                      fir_kernel=(1, 3, 3, 1), skip_rescale=True,
                      resblock_type="biggan", progressive="none",
                      progressive_input="none", progressive_combine="sum",
                      init_scale=0.0, nonlinearity="swish",
                      embedding_type="positional")
  config.data.image_size = 8
  model = NCSNpp.from_config(config)
  bits = {m.bits for m in model.modules()
          if isinstance(m, port_dropout.Dropout)}
  assert bits == {want}


def test_packed_draw_is_the_global_batch_cut_to_a_rank():
  """Under data parallelism a rank's lanes are the global batch's rows,
  under a space axis its image rows too."""
  gen = torch.Generator()
  whole = port_dropout.draw_lanes((4, 8, 3, 8), 8, gen.manual_seed(0), "cpu")
  assert whole.min() >= 0 and whole.max() < 256
  with port_dropout.batch_shard(1, 2):
    got = port_dropout.draw_lanes((2, 8, 3, 8), 8, gen.manual_seed(0), "cpu")
  assert torch.equal(got, whole[2:])
  with port_dropout.batch_shard(1, 2, 1, 2):
    got = port_dropout.draw_lanes((2, 4, 3, 8), 8, gen.manual_seed(0), "cpu")
  assert torch.equal(got, whole[2:, 4:])
