"""The port's FID / KID / IS pieces against the JAX package's, on the CPU:
the metrics on fixed arrays (1e-10 relative, and FID's eps retries and
raises taken as JAX takes them; the Newton-Schulz FID 1e-3),
the resizes against ``jax.image.resize`` (cubic 32 -> 299 on [0, 255]
within 1e-3 absolute, the antialiased linear 32 -> 16 within 1e-5) and
PIL's, the dummy extractor (1e-5 relative), the Inception forward at 75^2,
batch 2, on weights the port draws and JAX loads from the port's npz
(features rtol = atol = 1e-4, probabilities atol 1e-6, as
tests/test_inception_parity.py holds JAX's to its torch oracle; JAX's
forward jitted once per module), and the npz layout of the weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from soft_truncation_tpu.eval import inception as jax_inception
from soft_truncation_tpu.eval import inception_v3 as jax_v3
from soft_truncation_tpu.eval import metrics as jax_metrics
from soft_truncation_tpu_torch.eval import inception, inception_v3, metrics

import torch_tiny  # noqa: F401  (caps torch's threads)

REL = 1e-10


def _moments(seed, n, d, loc=0.0):
  return jax_metrics.compute_stats(
      np.random.RandomState(seed).normal(loc=loc, size=(n, d)))


def _metric_case(name):
  """(port value, JAX value) of one metric on fixed arrays."""
  rng = np.random.RandomState(7)
  f1 = rng.normal(size=(300, 12))
  f2 = rng.normal(loc=0.3, scale=1.2, size=(250, 12))
  if name == "compute_stats":
    return (np.concatenate([a.ravel() for a in metrics.compute_stats(f1)]),
            np.concatenate([a.ravel() for a in jax_metrics.compute_stats(f1)]))
  if name == "frechet":
    args = (*_moments(1, 300, 12), *_moments(2, 250, 12, 0.3))
  elif name == "frechet_rank_deficient":  # 8 samples of 64-d features
    args = (*_moments(0, 8, 64), *_moments(3, 8, 64, 0.2))
  elif name == "frechet_eps_retry":
    # a covariance with a slightly negative eigenvalue: the root's diagonal
    # is imaginary (3e-3) until eps = 1e-4 shifts it
    args = (np.zeros(2), np.eye(2), np.ones(2), np.diag([1.0, -1e-5]), 1e-4)
  if name.startswith("frechet"):
    return _with_sqrtm_calls(metrics, args), _with_sqrtm_calls(jax_metrics,
                                                               args)
  if name == "kernel_distance":
    return (metrics.kernel_distance(f1, f2),
            jax_metrics.kernel_distance(f1, f2))
  probs = rng.dirichlet(np.full(10, 0.3), size=97)
  return (metrics.inception_score_from_probs(probs),
          jax_metrics.inception_score_from_probs(probs))


def _with_sqrtm_calls(module, args):
  """(frechet_distance(*args), the matrix roots it took) in ``module``."""
  calls = []
  sqrtm = module._sqrtm

  def counted(a):
    calls.append(a)
    return sqrtm(a)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(module, "_sqrtm", counted)
    return module.frechet_distance(*args), len(calls)


@pytest.mark.parametrize("name", ["compute_stats", "frechet",
                                  "frechet_rank_deficient",
                                  "frechet_eps_retry", "kernel_distance",
                                  "inception_score"])
def test_metrics_match_jax(name):
  got, want = _metric_case(name)
  if name.startswith("frechet"):
    (got, got_calls), (want, want_calls) = got, want
    assert got_calls == want_calls == (2 if name.endswith("retry") else 1)
  np.testing.assert_allclose(got, want, rtol=REL, atol=0)


@pytest.mark.parametrize("case", ["non_finite", "imaginary_after_retry"])
def test_frechet_distance_raises_as_jax_does(case):
  if case == "non_finite":  # no retry can make a nan covariance finite
    d = 16
    mu, s1, s2 = np.zeros(d), np.eye(d), np.eye(d)
    s1[0, 0] = np.nan
  else:  # a nilpotent product: its root stays imaginary after the retry
    mu, s1, s2 = np.zeros(2), np.diag([1.0, 0.0]), np.array([[0.0, 1.0],
                                                             [1.0, 0.0]])
  with pytest.raises(ValueError) as want:
    jax_metrics.frechet_distance(mu, s1, mu, s2)
  with pytest.raises(ValueError) as got:
    metrics.frechet_distance(mu, s1, mu, s2)
  assert str(got.value) == str(want.value)


def test_frechet_distance_torch_matches_jax():
  args = (*_moments(1, 800, 12), *_moments(2, 800, 12, 0.3))
  want = float(jax_metrics.frechet_distance_jax(*args))
  got = metrics.frechet_distance_torch(*args)
  assert got.dtype == torch.float32 and got.device.type == "cpu"
  assert float(got) == pytest.approx(want, rel=1e-3)
  # and the exact value within the iteration's f32 accuracy
  assert float(got) == pytest.approx(metrics.frechet_distance(*args),
                                     rel=2e-2)


def _nhwc(x):
  return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_cubic_resize_matches_jax():
  x = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(
      np.float32)
  want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                     "cubic"))
  got = inception.resize(_nhwc(x), 299, 299, "cubic").permute(0, 2, 3, 1)
  assert np.abs(got.numpy() - want).max() <= 1e-3
  # torch's own bicubic (a = -0.75, no renormalisation) is another function
  other = torch.nn.functional.interpolate(_nhwc(x), size=(299, 299),
                                          mode="bicubic")
  assert np.abs(other.permute(0, 2, 3, 1).numpy() - want).max() > 1.0


def test_antialiased_linear_downsample_matches_jax():
  x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
      np.float32)
  want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 16, 16, 3),
                                     "linear"))
  got = inception.resize(_nhwc(x), 16, 16, "linear").permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
  # without the antialiasing filter it would be a 2-tap average
  plain = inception.resize(_nhwc(x), 16, 16, "linear", antialias=False)
  assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_resize_weights_match_jax_and_are_cached():
  from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat
  want = np.asarray(compute_weight_mat(32, 299, 299 / 32, 0.0,
                                       _fill_keys_cubic_kernel, True))
  got = inception.resize_weights(32, 299, "cubic")
  # JAX evaluates the kernel in f32, the port in float64
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  assert inception.resize_weights(32, 299, "cubic") is got


def test_clean_resize_matches_jax():
  pytest.importorskip("PIL")
  x = np.random.default_rng(2).integers(0, 256, (2, 20, 24, 3),
                                        dtype=np.uint8)
  np.testing.assert_array_equal(inception.clean_resize(x, 37),
                                jax_inception.clean_resize(x, 37))


def test_dummy_extractor_matches_jax():
  images = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
  want_f, want_p = jax_inception.DummyFeatureExtractor()(images)
  extractor = inception.DummyFeatureExtractor()
  got_f, got_p = extractor(images)
  assert extractor.fingerprint == jax_inception.DummyFeatureExtractor(
  ).fingerprint
  np.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=1e-5 * np.abs(
      want_f).max())
  np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
  """Random weights drawn by the port, written by its save_params_npz,
  read by both packages' loaders; JAX's parameter shapes from an
  eval_shape of its init (no compile)."""
  path = str(tmp_path_factory.mktemp("inception") / "w.npz")
  state = inception_v3.random_params(seed=0)
  inception_v3.save_params_npz(state, path)
  shapes = jax.eval_shape(
      lambda k: jax_v3.InceptionV3().init(k, jnp.zeros((1, 75, 75, 3))),
      jax.random.PRNGKey(0))["params"]
  return path, state, {"/".join(k): v.shape
                       for k, v in flatten_dict(shapes).items()}


def test_inception_forward_matches_jax(weights):
  path, _, _ = weights
  x = np.random.default_rng(4).uniform(0, 255, (2, 75, 75, 3)).astype(
      np.float32)
  params = jax_v3.load_params_npz(path)
  model = jax_v3.InceptionV3()
  want_f, want_p = jax.jit(lambda p, x: model.apply({"params": p}, x))(
      params, jnp.asarray(x))
  port = inception_v3.load_params_npz(path)
  with torch.inference_mode():
    got_f, got_p = port(_nhwc(x))
  assert float(np.asarray(want_f).std()) > 1e-2  # the He gain keeps signal
  np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-4,
                             atol=1e-4)
  np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4,
                             atol=1e-6)


def test_weight_map_is_the_flax_layout(weights):
  """Every npz key is a parameter of JAX's InceptionV3 with its shape: conv
  kernels HWIO, fc (in, out), the BatchNorm names."""
  path, state, jax_shapes = weights
  with np.load(path) as flat:
    got = {k: flat[k].shape for k in flat.files}
  assert got == jax_shapes
  assert got["Mixed_6b/branch7x7_2/conv/kernel"] == (1, 7, 128, 128)
  assert state["Mixed_6b.branch7x7_2.conv.weight"].shape == (128, 128, 1, 7)
  assert got["fc/kernel"] == (2048, 1000)
  assert {k.rsplit("/", 1)[1] for k in got} == {
      "kernel", "bias", "bn_scale", "bn_bias", "bn_mean", "bn_var"}
  with np.load(path) as flat:
    np.testing.assert_array_equal(
        flat["Conv2d_2b_3x3/conv/kernel"],
        state["Conv2d_2b_3x3.conv.weight"].numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(flat["fc/kernel"],
                                  state["fc.weight"].numpy().T)


def test_random_params_have_the_flax_init_distribution(weights):
  _, state, _ = weights
  k = state["Mixed_7c.branch3x3dbl_2.conv.weight"]  # fan_in 3 * 3 * 448
  std = np.sqrt(2.0 / (9 * 448))
  assert float(k.std()) == pytest.approx(std, rel=0.01)
  assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
  fc = state["fc.weight"]
  assert float(fc.std()) == pytest.approx(np.sqrt(1 / 2048), rel=0.01)
  assert not state["fc.bias"].any() and not state[
      "Mixed_5b.branch_pool.bn_mean"].any()
  assert (state["Mixed_5b.branch_pool.bn_var"] == 1).all()
  again = inception_v3.random_params(seed=0)
  assert all(torch.equal(again[n], t) for n, t in state.items())


def test_load_params_npz_round_trip_and_refusals(weights, tmp_path):
  path, state, _ = weights
  model = inception_v3.load_params_npz(path)
  assert all(torch.equal(model.state_dict()[n], t) for n, t in state.items())
  with np.load(path) as flat:
    arrays = dict(flat)
  np.savez(tmp_path / "extra.npz", **arrays,
           **{"Mixed_5b/branch9x9/conv/kernel": np.zeros((1, 1, 1, 1))})
  with pytest.raises(KeyError, match="branch9x9"):
    inception_v3.load_params_npz(str(tmp_path / "extra.npz"))
  arrays.pop("Mixed_7c/branch_pool/bn_var")
  np.savez(tmp_path / "missing.npz", **arrays)
  with pytest.raises(KeyError, match="Mixed_7c/branch_pool/bn_var"):
    inception_v3.load_params_npz(str(tmp_path / "missing.npz"))


def test_inception_extractor_resizes_on_the_device_or_the_host(weights):
  """``'device'`` resizes the uint8 images with the cubic product, ``'host'``
  with PIL (on the CPU here), and the fingerprint is the npz's md5."""
  path, _, _ = weights
  images = np.random.default_rng(5).integers(0, 256, (3, 20, 20, 3),
                                             dtype=np.uint8)
  model = inception_v3.load_params_npz(path)
  got = {}
  for mode in ("device", "host"):
    extractor = inception.InceptionExtractor(path, batch_size=2,
                                             resize_mode=mode, device="cpu")
    assert extractor.fingerprint.startswith("torch:")
    assert len(extractor.fingerprint) == len("torch:") + 12
    if mode == "host" and not _has_pil():
      continue
    got[mode] = extractor(images)
  with torch.inference_mode():
    x = inception.resize(torch.from_numpy(images).permute(0, 3, 1, 2).float(),
                         299, 299, "cubic")
    want_f, want_p = model(x)
  np.testing.assert_allclose(got["device"][0], want_f.numpy(), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(got["device"][1], want_p.numpy(), rtol=1e-5,
                             atol=1e-7)
  if "host" in got:
    with torch.inference_mode():
      want_host = model(torch.from_numpy(inception.clean_resize(
          images)).permute(0, 3, 1, 2))[0]
    np.testing.assert_allclose(got["host"][0], want_host.numpy(), rtol=1e-5,
                               atol=1e-6)


def _has_pil():
  try:
    import PIL  # noqa: F401
  except ImportError:
    return False
  return True


def test_get_feature_extractor_reads_the_assetdir(weights, tmp_path):
  from soft_truncation_tpu_torch.configs.base import default_config
  path, _, _ = weights
  config = default_config()
  assert isinstance(inception.get_feature_extractor(config, str(tmp_path)),
                    inception.DummyFeatureExtractor)
  with pytest.raises(RuntimeError, match="No Inception backend"):
    inception.get_feature_extractor(config, str(tmp_path), allow_dummy=False)
  os.symlink(path, tmp_path / inception.WEIGHTS_FILE)
  config.tpu.fid_resize = "device"
  extractor = inception.get_feature_extractor(config, str(tmp_path),
                                              device="cpu")
  assert isinstance(extractor, inception.InceptionExtractor)
  assert extractor.resize_mode == "device"
  # a broken weights file raises; it does not become the dummy
  (tmp_path / "broken").mkdir()
  (tmp_path / "broken" / inception.WEIGHTS_FILE).write_bytes(b"not an npz")
  with pytest.raises(Exception):
    inception.get_feature_extractor(config, str(tmp_path / "broken"),
                                    device="cpu")
