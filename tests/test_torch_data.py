"""The port's data path for the published configs (soft_truncation_tpu_torch/
data/{resize,tfrecords,datasets}.py) against the JAX package's TF ops and
readers, on the CPU.

Tolerances:
- the antialiased bilinear resizes (``tf.image.resize``, ``resize_small``):
  2e-6 absolute on [0, 1]. TF sums its float32 weights in its own order;
  the port builds the same weights in float64 and sums in float32.
- LSUN's ``crop_resize`` ends in TF's cast to uint8 (saturating where the
  bicubic overshoots [0, 255], toward zero inside): its float values
  within 1e-3 of TF's on [0, 255] (4e-6 of the range: sums of up to a few
  dozen f32 products of values near 255, in another order), and the uint8
  bytes equal wherever the float lies more than 1e-3 from an integer
  (where it lies closer, rounding decides the truncation, and the byte may
  be off by one).
- the crops and the TFRecord reader: exact.
"""

import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.data import datasets as jax_datasets
from soft_truncation_tpu_torch.configs.base import Config
from soft_truncation_tpu_torch.data import datasets, resize, tfrecords


def _images(n, h, w, seed=0, sharp=True):
  """uint8 images; ``sharp`` alternates black and white blocks under the
  noise, so that the bicubic kernel overshoots [0, 255]."""
  rng = np.random.default_rng(seed)
  x = rng.integers(0, 256, (n, h, w, 3))
  if sharp:
    x = np.where((np.arange(w)[None, None, :, None] // 3) % 2, 255, 0)
    x = np.broadcast_to(x, (n, h, w, 3)) ^ rng.integers(0, 8, (n, h, w, 3))
  return x.astype(np.uint8)


@pytest.mark.parametrize("out", [(24, 24), (20, 28), (64, 48)])
def test_tf_resize_matches_tf(out):
  x = resize.convert_to_float(_images(2, 40, 52, sharp=False))
  want = tf.image.resize(x, out, antialias=True).numpy()
  got = resize.tf_resize(x, *out)
  assert got.shape == want.shape and got.dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("hw,res", [((40, 52), 24), ((52, 40), 24),
                                    ((30, 30), 64), ((40, 52), 40)])
def test_crop_resize_matches_tf_with_its_overshoot(hw, res):
  images = _images(3, *hw)
  got = resize.crop_resize(images, res)
  wants, floats = [], []
  for img in images:
    wants.append(jax_datasets.crop_resize(tf.constant(img), res).numpy())
    crop = min(hw)
    top, left = (hw[0] - crop) // 2, (hw[1] - crop) // 2
    floats.append(tf.image.resize(
        img[top:top + crop, left:left + crop], (res, res), antialias=True,
        method=tf.image.ResizeMethod.BICUBIC).numpy())
  want, want_f = np.stack(wants), np.stack(floats)
  got_f = resize.tf_resize(images[:, (hw[0] - min(hw)) // 2:
                                  (hw[0] + min(hw)) // 2,
                                  (hw[1] - min(hw)) // 2:
                                  (hw[1] + min(hw)) // 2], res, res,
                           "bicubic")
  np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-3)
  if res < min(hw):  # a downsample of sharp edges overshoots both ways
    assert (want_f < 0).any() and (want_f > 255).any()
  clear = np.abs(want_f - np.round(want_f)) > 1e-3
  assert got.dtype == np.uint8
  np.testing.assert_array_equal(got[clear], want[clear])
  assert (np.abs(got.astype(int) - want.astype(int))[~clear] <= 1).all()


def test_resize_small_and_central_crop_match_tf():
  images = _images(2, 218, 178, sharp=False)
  x = resize.convert_to_float(images)
  got = resize.resize_small(resize.central_crop(x, 140), 64)
  want = np.stack([jax_datasets.resize_small(
      jax_datasets.central_crop(tf.image.convert_image_dtype(img,
                                                             tf.float32),
                                140), 64).numpy() for img in images])
  np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
  # aspect kept with int(side * ratio)
  assert resize.resize_small(x[:, :100], 64).shape == (2, 64, 113, 3)
  np.testing.assert_array_equal(
      resize.central_crop(images, 140),
      np.stack([jax_datasets.central_crop(tf.constant(img), 140).numpy()
                for img in images]))
  with pytest.raises(ValueError, match="central_crop"):
    resize.central_crop(images[:, :100, :100], 140)


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------


def _write_tfrecords(path, images):
  with tf.io.TFRecordWriter(str(path)) as w:
    for img in images:
      chw = np.ascontiguousarray(img.transpose(2, 0, 1))
      ex = tf.train.Example(features=tf.train.Features(feature={
          "shape": tf.train.Feature(
              int64_list=tf.train.Int64List(value=chw.shape)),
          "data": tf.train.Feature(
              bytes_list=tf.train.BytesList(value=[chw.tobytes()]))}))
      w.write(ex.SerializeToString())


def test_tfrecord_reader_matches_jax_and_checks_crcs(tmp_path):
  assert tfrecords.crc32c(b"123456789") == 0xE3069283
  images = _images(5, 16, 12, sharp=False)
  path = tmp_path / "data.tfrecords"
  _write_tfrecords(path, images)
  config = jax_default("lsun")
  config.data.tfrecords_path = str(path)
  want = np.stack([d["image"] for d in
                   jax_datasets._load_tfrecords(config).as_numpy_iterator()])
  got = tfrecords.TFRecordImages(str(path))
  assert len(got) == 5 and got.shape == (5, 16, 12, 3)
  np.testing.assert_array_equal(got[np.arange(5)], want)
  np.testing.assert_array_equal(got[[3, 1]], want[[3, 1]])

  raw = bytearray(path.read_bytes())
  (length,) = struct.unpack_from("<Q", raw, 0)
  data = bytearray(raw)
  data[(12 + length + 4) + 12 + length // 2] ^= 0x01  # in record 1
  bad = tmp_path / "bad_data.tfrecords"
  bad.write_bytes(bytes(data))
  reader = tfrecords.TFRecordImages(str(bad))
  with pytest.raises(ValueError, match="CRC"):
    reader[[0, 1]]
  np.testing.assert_array_equal(reader[[0, 2]], want[[0, 2]])
  header = bytearray(raw)
  header[8] ^= 0x01  # the first length's CRC
  bad.write_bytes(bytes(header))
  with pytest.raises(ValueError, match="CRC"):
    tfrecords.TFRecordImages(str(bad))


def test_ffhq_reads_its_tfrecords_first(tmp_path):
  images = _images(6, 16, 16, sharp=False)
  _write_tfrecords(tmp_path / "ffhq.tfrecords", images)
  config = Config(jax_default("lsun").to_dict())
  config.data.update(dataset="FFHQ", image_size=16, random_flip=False,
                     tfrecords_path=str(tmp_path / "ffhq.tfrecords"))
  config.training.batch_size = 6
  batch = next(datasets.get_train_iterator(config, 0))
  # JAX's transport_uint8 says float32 for FFHQ: x * f32(1/255)
  assert batch.dtype == np.float32
  assert sorted(map(bytes, batch)) == sorted(map(
      bytes, resize.convert_to_float(images)))


# ---------------------------------------------------------------------------
# float32 transport of a resized dataset
# ---------------------------------------------------------------------------


def test_celeba_npz_goes_through_as_float32_like_jax(tmp_path):
  images = _images(5, 218, 178, sharp=False)
  np.savez(tmp_path / "celeba_test.npz", images=images)
  np.savez(tmp_path / "celeba_train.npz", images=images)
  jc = jax_default("celeba")
  jc.data.data_dir = str(tmp_path)
  pc = Config(jc.to_dict())
  pc.eval.batch_size, pc.training.batch_size = 5, 5
  assert not datasets.transport_uint8(pc)
  assert datasets.transport_uint8(pc) == jax_datasets.transport_uint8(jc)
  op = jax_datasets._resize_op(jc)
  (got,) = datasets.get_eval_iterator(pc)
  order = np.random.default_rng(pc.seed).permutation(5)
  want = np.stack([op(tf.constant(img)).numpy() for img in images[order]])
  assert got.dtype == np.float32 and got.shape == (5, 64, 64, 3)
  np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
  train = next(datasets.get_train_iterator(pc, 0))
  assert train.dtype == np.float32 and train.shape == (5, 64, 64, 3)
  # the device takes float32 batches: x as it is, or (255 x + u) / 256
  pc.data.dequantization = "uniform"
  x = torch.from_numpy(got)
  u = torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
  dq = datasets.make_preprocess_fn(pc)(x, torch.Generator().manual_seed(0))
  torch.testing.assert_close(dq, (255.0 * x + u) / 256.0, rtol=0, atol=0)
