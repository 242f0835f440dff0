"""The port's FID pipeline against the JAX package's, on the CPU, and the two
faults repaired before it.

- ``compute_fid_and_is`` of both packages on the same ``samples_<r>.npz``
  shards (numpy uint8, so no sampler runs) with the dummy extractor and an
  assetdir ``cifar10_stats.npz`` of raw ``pool_3`` features: FID, KID and
  IS within 1e-6 relative, the same directory names; the feature caches
  are keyed by the extractor's fingerprint; a shard issued when
  featurising raises is written; the streamed real-side statistics are
  JAX's (1e-6 relative); ``load_dataset_stats`` as JAX's, and cleanfid's
  functions on one feature map within 1e-10; the PNG grid decodes to
  JAX's.
- Fault 1: every fused site of the 256^2 UNCSN++ layout
  (``ve/celebahq_256_uncsn.py``, its widths from the JAX config; walked on
  the meta device, so no 256^2 forward runs) is eligible with a launch
  plan that fits, for the primal and the tangent, or is routed to the
  plain chain, and the port's guard agrees with JAX's at every site; both
  32^2 models keep their 82 fused sites.
- Fault 2: the evaluation split and its size are JAX's (CIFAR-10,
  IMAGENET32, LSUN on Synthetic data), and the eval loops wrap as JAX's
  ``get_batch`` does.
"""

import collections
import io
import os
import types

import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.configs.ve import celebahq_256_uncsn
from soft_truncation_tpu.configs.vp.IMAGENET32 import ddpmpp_st as imagenet32
from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu.eval import cleanfid_api as jax_cleanfid
from soft_truncation_tpu.eval import evaluation as jax_evaluation
from soft_truncation_tpu.eval import inception as jax_inception
from soft_truncation_tpu.eval import sampling_io as jax_sampling_io
from soft_truncation_tpu.models import layerspp as jax_layerspp
from soft_truncation_tpu_torch.configs.base import Config, load_config
from soft_truncation_tpu_torch.data import datasets
from soft_truncation_tpu_torch.eval import (cleanfid_api, evaluation,
                                            inception, sampling_io)
from soft_truncation_tpu_torch.models import layerspp
from soft_truncation_tpu_torch.models.registry import get_model
from soft_truncation_tpu_torch.ops import gn_conv

import torch_tiny

REL = 1e-6
SHARD, ROUNDS, STEP = 8, 3, 5


def _images(seed, n, size=16):
  return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
  """(JAX config, port config, root): the same shards under root/jax and
  root/port, and an assetdir whose cifar10_stats.npz holds the dummy
  features of 40 'real' images."""
  jc, pc = torch_tiny.configs()
  for c in (jc, pc):
    c.sampling.batch_size = SHARD
  root = tmp_path_factory.mktemp("fid")
  for side, config in (("jax", jc), ("port", pc)):
    d = sampling_io.get_dir_name(config, str(root / side), STEP)
    os.makedirs(d)
    for r in range(ROUNDS):
      np.savez_compressed(os.path.join(d, f"samples_{r}.npz"),
                          samples=_images(r, SHARD))
  os.makedirs(root / "assets")
  real, _ = jax_inception.DummyFeatureExtractor()(_images(10, 40))
  np.savez(root / "assets" / "cifar10_stats.npz", pool_3=real)
  return jc, pc, root


def test_compute_fid_and_is_matches_jax_on_shared_shards(shared):
  jc, pc, root = shared
  num = SHARD * ROUNDS - 3  # the last shard is cut
  want = jax_evaluation.compute_fid_and_is(
      jc, None, None, None, STEP, str(root / "jax"), str(root / "assets"),
      num, extractor=jax_inception.DummyFeatureExtractor())
  got = evaluation.compute_fid_and_is(
      pc, None, None, STEP, str(root / "port"), str(root / "assets"), num,
      extractor=inception.DummyFeatureExtractor())
  assert set(got) == set(want) == {"fid", "kid", "inception_score"}
  for k in want:
    assert got[k] == pytest.approx(want[k], rel=REL), k
  jdir = jax_sampling_io.get_dir_name(jc, str(root / "jax"), STEP)
  pdir = sampling_io.get_dir_name(pc, str(root / "port"), STEP)
  assert os.path.relpath(pdir, root / "port") == os.path.relpath(
      jdir, root / "jax")
  assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
  with np.load(os.path.join(pdir, "report_metrics.npz")) as f:
    assert {k: float(f[k]) for k in f.files} == got
  # a second run reads every cache: the same numbers
  again = evaluation.compute_fid_and_is(
      pc, None, None, STEP, str(root / "port"), str(root / "assets"), num,
      extractor=inception.DummyFeatureExtractor())
  assert again == got


def test_get_dir_name_matches_jax_for_pc():
  jc, pc = torch_tiny.configs({}, torch_tiny.UNCSNPP)
  assert (sampling_io.get_dir_name(pc, "s", 7)
          == jax_sampling_io.get_dir_name(jc, "s", 7))


def test_feature_caches_follow_the_extractor(shared, tmp_path):
  _, pc, _ = shared
  images = _images(3, 4)
  first = inception.DummyFeatureExtractor()
  other = inception.DummyFeatureExtractor(feature_dim=8)
  path = os.path.join(sampling_io.get_dir_name(pc, str(tmp_path), 0),
                      "statistics_0.npz")
  os.makedirs(os.path.dirname(path))
  feats, _ = sampling_io.get_latents(pc, images, first, 0, 0, str(tmp_path))
  assert feats.shape == (4, 16)
  # another fingerprint: computed again and stored under it
  feats, _ = sampling_io.get_latents(pc, images, other, 0, 0, str(tmp_path))
  assert feats.shape == (4, 8)
  with np.load(path) as f:
    assert str(f["fingerprint"]) == other.fingerprint
  # a cache the JAX package's Inception wrote ("flax:...") is not reused
  np.savez(path, pool_3=np.zeros((4, 2048)), fingerprint="flax:0123456789ab")
  feats, _ = sampling_io.get_latents(pc, images, first, 0, 0, str(tmp_path))
  assert feats.shape == (4, 16)
  # the real-side cache too
  cache = str(tmp_path / "real.npz")
  batches = [_images(4, 4), _images(5, 4)]
  mu, _ = evaluation.compute_dataset_stats(pc, batches, first, 8, cache)
  mu8, _ = evaluation.compute_dataset_stats(pc, batches, other, 8, cache)
  assert mu.shape == (16,) and mu8.shape == (8,)


class _Raises(inception.DummyFeatureExtractor):
  def __call__(self, images_uint8):
    raise RuntimeError("featurising failed")


def test_an_issued_shard_is_written_when_featurising_raises(shared,
                                                            tmp_path):
  _, pc, _ = shared
  model = torch.nn.Linear(1, 1)
  calls = []

  def sampling_fn(model, generator):
    calls.append(generator.initial_seed())
    x = torch.rand(SHARD, 16, 16, 3, generator=generator)
    return x, 3

  with pytest.raises(RuntimeError, match="featurising failed"):
    evaluation.compute_fid_and_is(pc, model, sampling_fn, 0, str(tmp_path),
                                  None, SHARD * ROUNDS, eval_ds=[],
                                  extractor=_Raises())
  d = sampling_io.get_dir_name(pc, str(tmp_path), 0)
  # shard 0 was read, shard 1 issued before it was featurised: both written
  assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
      "samples_0.npz", "samples_1.npz"]
  assert calls == [evaluation.shard_seed(pc.seed, r) for r in range(2)]
  with np.load(os.path.join(d, "samples_1.npz")) as f:
    want = torch.rand(SHARD, 16, 16, 3, generator=torch.Generator(
    ).manual_seed(calls[1]))
    np.testing.assert_array_equal(f["samples"],
                                  sampling_io._to_uint8(want).numpy())
  assert os.path.exists(os.path.join(d, "samples_1.png"))


def test_streamed_real_stats_match_jax(shared):
  jc, pc, _ = shared
  batches = [_images(20 + i, 6) for i in range(4)]  # a short last read

  class Stream:
    def as_numpy_iterator(self):
      for b in batches:
        yield {"image": b.astype(np.float32) / np.float32(255.0)}

  want = jax_evaluation.compute_dataset_stats(
      jc, Stream(), jax_inception.DummyFeatureExtractor(), 20)
  got = evaluation.compute_dataset_stats(
      pc, iter(batches), inception.DummyFeatureExtractor(), 20)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=REL, atol=REL * np.abs(w).max())


@pytest.mark.parametrize("fmt", ["pool_3", "pool_3_4d", "moments", "sigma",
                                 "bad_keys", "unknown_dataset"])
def test_load_dataset_stats_matches_jax(fmt, tmp_path):
  jc, pc = jax_default("cifar10"), torch_tiny.configs({})[1]
  rng = np.random.RandomState(0)
  feats = rng.normal(size=(60, 8)).astype(np.float32)
  name, arrays = "cifar10_stats.npz", {"pool_3": feats}
  if fmt == "pool_3_4d":
    arrays = {"pool_3": feats.reshape(60, 1, 1, 8)}
  elif fmt in ("moments", "sigma"):
    mu, cov = np.mean(feats, 0), np.cov(feats, rowvar=False)
    arrays = {"mu": mu, "cov" if fmt == "moments" else "sigma": cov}
    for c in (jc, pc):
      c.data.dataset, c.data.image_size, c.data.category = (
          "LSUN", 96, "church_outdoor")
    name = "LSUN_church_outdoor_96_clean_stats.npz"
  elif fmt == "bad_keys":
    arrays = {"something_else": feats}
  elif fmt == "unknown_dataset":
    jc.data.dataset = pc.data.dataset = "NOPE"
  np.savez(tmp_path / name, **arrays)
  if fmt in ("bad_keys", "unknown_dataset"):
    error = KeyError if fmt == "bad_keys" else ValueError
    with pytest.raises(error):
      jax_evaluation.load_dataset_stats(jc, str(tmp_path))
    with pytest.raises(error):
      evaluation.load_dataset_stats(pc, str(tmp_path))
    return
  want = jax_evaluation.load_dataset_stats(jc, str(tmp_path))
  got = evaluation.load_dataset_stats(pc, str(tmp_path))
  for g, w in zip(got, want):
    if w is None:
      assert g is None
    else:
      np.testing.assert_array_equal(g, w)


class _BlockMeans(inception.FeatureExtractor):
  """Means of 16 blocks of each image, in float64: one feature map for both
  packages, so that their cleanfid functions see the same features."""

  name = "block_means"

  def __call__(self, images_uint8):
    n = len(images_uint8)
    return images_uint8.reshape(n, 16, -1).mean(-1), None


def test_cleanfid_functions_match_jax(tmp_path):
  for name, seeds in (("a", (0, 1)), ("b", (2, 3))):
    os.makedirs(tmp_path / name)
    for i, seed in enumerate(seeds):
      np.savez(tmp_path / name / f"samples_{i}.npz",
               samples=_images(seed, 32))
  batches = [_images(7, 32), _images(8, 32)]

  class Stream:
    def as_numpy_iterator(self):
      for b in batches:
        yield {"image": b.astype(np.float32) / np.float32(255.0)}

  a, b = str(tmp_path / "a"), str(tmp_path / "b")
  pairs = [
      (jax_cleanfid.compute_fid(a, fdir2=b, extractor=_BlockMeans()),
       cleanfid_api.compute_fid(a, fdir2=b, extractor=_BlockMeans())),
      (jax_cleanfid.compute_fid(a, dataset=Stream(), num_data=60,
                                extractor=_BlockMeans()),
       cleanfid_api.compute_fid(a, dataset=iter(batches), num_data=60,
                                extractor=_BlockMeans())),
      (jax_cleanfid.compute_kid(a, dataset=Stream(), num_data=60,
                                extractor=_BlockMeans()),
       cleanfid_api.compute_kid(a, dataset=iter(batches), num_data=60,
                                extractor=_BlockMeans())),
      (jax_cleanfid.compute_kid(a, fdir2=b, extractor=_BlockMeans()),
       cleanfid_api.compute_kid(a, fdir2=b, extractor=_BlockMeans()))]
  for want, got in pairs:
    assert got == pytest.approx(want, rel=1e-10)
  assert os.path.exists(tmp_path / "a" / "features_block_means.npz")


@pytest.mark.parametrize("channels", [3, 1])
def test_png_grid_decodes_to_jax_grid(channels):
  Image = pytest.importorskip("PIL.Image")
  samples = _images(9, 10)[..., :channels]
  got, want = io.BytesIO(), io.BytesIO()
  sampling_io.save_image_grid(samples, got, format="PNG")
  jax_sampling_io.save_image_grid(samples, want, format="PNG")
  got.seek(0)
  want.seek(0)
  np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                np.asarray(Image.open(want)))


# --- fault 1: fused sites wider than the kernel takes ------------------------


def _fused_sites(config, size):
  """(block, (N, H, W, C), O, port guard) of every res-block norm -> conv
  site of ``config``'s network in one eval forward at ``size``^2, walked on
  the meta device: each site takes the plain chain there, and FIR resamples
  only give their output's shape."""
  with torch.device("meta"):
    model = get_model(config.model.name).from_config(config).eval()
  sites = []

  def record(block, h, out_ch, train):
    sites.append((block, tuple(h.shape), out_ch,
                  eligible(block, h, out_ch, train)))
    return False

  def shape_only(module, x, mode, fir_kernel):
    n, h, w, c = x.shape
    return x.new_empty((n, 2 * h, 2 * w, c) if mode == "up"
                       else (n, h // 2, w // 2, c))

  eligible = layerspp._gn_conv_eligible
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(layerspp, "_gn_conv_eligible", record)
    mp.setattr(layerspp, "_fir_resample", shape_only)
    x = torch.empty(1, size, size, 3, device="meta")
    with torch.inference_mode():
      model(x, torch.ones(1, device="meta"))
  return sites


def test_wide_sites_fit_the_kernel_or_take_the_chain(monkeypatch):
  jc = celebahq_256_uncsn.get_config()
  pc = load_config(torch_tiny.PORT_UNCSNPP)
  pc.model.update(jc.model)
  pc.data.image_size = jc.data.image_size
  sites = _fused_sites(pc, 256)
  assert len(sites) == 86
  monkeypatch.setattr(jax_layerspp, "_PALLAS_GN_CONV", True)
  fused = 0
  for block, (n, h, w, c), o, ok in sites:
    jax_block = types.SimpleNamespace(act=jax.nn.silu)
    assert ok == jax_layerspp._gn_conv_eligible(
        jax_block, np.zeros((n, h, w, c), np.float32), o, False), (h, w, c, o)
    if ok:
      fused += 1
      assert w <= gn_conv.BM
      for tangent in (False, True):
        plan = gn_conv.launch_plan(n, h, w, c, o, min(c // 4, 32),
                                   tangent=tangent)
        assert plan.smem <= gn_conv._MAX_SMEM
    else:
      assert h * w * max(c, o) > layerspp._GN_CONV_MAX_HWC
  assert 0 < fused < len(sites)
  # the kernel's own limits, apart from JAX's guard
  assert not gn_conv.fits(1, 1, 256, 128, 128, 32)
  assert gn_conv.fits(8, 32, 32, 512, 256, 32)


@pytest.mark.parametrize("family", [torch_tiny.FLAGSHIP, torch_tiny.UNCSNPP])
def test_the_32px_models_keep_82_fused_sites(family):
  _, pc = torch_tiny.configs({}, family)
  sites = _fused_sites(pc, 32)
  assert sum(ok for *_, ok in sites) == len(sites) == 82


# --- fault 2: the evaluation split and its size ------------------------------


def _split_configs(name):
  """(JAX config, port config) of ``name`` at 8 px on Synthetic images."""
  jc = {"cifar10": lambda: jax_default("cifar10"),
        "imagenet32": imagenet32.get_config,
        "lsun": lambda: jax_default("lsun")}[name]()
  jc.data.image_size = 8
  pc = Config(jc.to_dict())
  pc.eval.batch_size = 500
  return jc, pc


@pytest.mark.parametrize("name", ["cifar10", "imagenet32", "lsun"])
def test_eval_split_and_size_are_jax(name):
  jc, pc = _split_configs(name)
  want_split = jax_datasets._SPLITS.get(jc.data.dataset,
                                        ("train", "train"))[1]
  assert datasets.eval_split(pc) == want_split
  assert want_split == {"cifar10": "test"}.get(name, "validation")
  want = jax_datasets._synthetic_array(jc, want_split)
  got = np.concatenate(list(datasets.get_eval_iterator(pc)))
  assert got.shape == want.shape
  # the same images, in the port's order
  assert sorted(map(bytes, got)) == sorted(map(bytes, datasets.synthetic_array(
      pc, want_split)))


def test_eval_batches_wrap_as_jax_get_batch(tmp_path):
  _, pc = _split_configs("cifar10")
  pc.data.data_dir, pc.eval.batch_size = str(tmp_path), 2
  images = _images(0, 5, size=8)
  np.savez(tmp_path / "cifar10_test.npz", images=images)
  one_pass = list(datasets.get_eval_iterator(pc))
  assert [len(b) for b in one_pass] == [2, 2, 1]

  class Dataset:
    def as_numpy_iterator(self):
      return ({"image": b} for b in one_pass)

  jc, _ = _split_configs("cifar10")
  want, it = [], iter(Dataset().as_numpy_iterator())
  for _ in range(7):
    batch, it = jax_datasets.get_batch(jc, it, Dataset())
    want.append(batch)
  got = [b for _, b in zip(range(7), datasets.eval_batches(pc))]
  assert [len(b) for b in got] == [2, 2, 1, 2, 2, 1, 2]
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  assert collections.Counter(map(bytes, np.concatenate(got[:3]))) == \
      collections.Counter(map(bytes, images))
