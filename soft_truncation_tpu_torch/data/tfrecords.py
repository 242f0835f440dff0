"""A reader of score_sde's image TFRecords, without TensorFlow.

The FFHQ and CelebA-HQ configs point ``data.tfrecords_path`` at one
TFRecord file whose records are ``tf.train.Example``s with ``shape`` (int64
x 3, CHW) and ``data`` (the uint8 pixels, CHW). The JAX package reads them
with tf.data (``soft_truncation_tpu/data/datasets.py::_load_tfrecords``);
the card's machine has no TensorFlow, so this module reads the framing and
the two features itself:

  * a record is: length (u64, little-endian), the masked CRC32C of those 8
    bytes (u32), the payload, the masked CRC32C of the payload (u32); both
    CRCs are checked, and a mismatch raises;
  * the payload is decoded as protobuf wire format, as far as
    Example -> Features -> map<string, Feature> -> BytesList / Int64List.

:class:`TFRecordImages` indexes the file once (each record's offset, its
header checked) and then reads the records an index asks for, CHW -> HWC,
so a batch iterator can draw from it as from a uint8 array [N, H, W, C]
without holding the file in memory.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Tuple

import numpy as np

_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli
_MASK_DELTA = 0xA282EAD8
_CHUNK = 1024  # bytes per lane of the vectorised CRC


def _crc_table() -> np.ndarray:
  table = np.zeros(256, np.uint32)
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
    table[i] = c
  return table


_TABLE = _crc_table()


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
  """The GF(2) matrix with columns ``cols`` (u32 [32]) times the words
  ``v`` (u32 [...])."""
  out = np.zeros_like(v)
  for b in range(32):
    out ^= np.where((v >> np.uint32(b)) & np.uint32(1), cols[b],
                    np.uint32(0)).astype(np.uint32)
  return out


@functools.lru_cache(maxsize=None)
def _zeros_operator(n: int) -> np.ndarray:
  """Columns of the map the register goes through over ``n`` zero bytes
  (cached: a dataset's records share their lengths; read-only)."""
  one = np.array([_TABLE[(1 << b) & 0xFF] ^ ((1 << b) >> 8)
                  for b in range(32)], np.uint32)
  result = np.array([1 << b for b in range(32)], np.uint32)
  while n:
    if n & 1:
      result = _apply(one, result)  # column j of A.B is A (B e_j)
    one = _apply(one, one)
    n >>= 1
  return result


def crc32c(data: bytes) -> int:
  """CRC32C of ``data``. Vectorised: the register's update is linear, so
  lanes of ``_CHUNK`` bytes run side by side from a zero register, and a
  tree of zero-byte shifts combines them."""
  n = len(data)
  if n < 4 * _CHUNK:  # a record's 8-byte length, say: byte by byte
    crc = 0xFFFFFFFF
    for byte in data:
      crc = int(_TABLE[(crc ^ byte) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
  buf = np.frombuffer(data, np.uint8)
  lanes = -(-n // _CHUNK)
  lanes = 1 << (lanes - 1).bit_length()
  # zeros in front leave a zero register as it is
  padded = np.zeros(lanes * _CHUNK, np.uint8)
  padded[lanes * _CHUNK - n:] = buf
  padded = padded.reshape(lanes, _CHUNK)
  reg = np.zeros(lanes, np.uint32)
  for i in range(_CHUNK):
    reg = _TABLE[(reg ^ padded[:, i]) & 0xFF] ^ (reg >> np.uint32(8))
  span = 1
  while len(reg) > 1:
    reg = _apply(_zeros_operator(_CHUNK * span), reg[0::2]) ^ reg[1::2]
    span *= 2
  # the 0xFFFFFFFF start, carried over n bytes, and the final inversion
  start = _apply(_zeros_operator(n), np.array([0xFFFFFFFF], np.uint32))
  return int((reg[0] ^ start[0]) ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data: bytes) -> int:
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _fields(buf: bytes):
  """(field number, wire type, value) of each field of a message; the
  value is an int (varint, fixed) or the bytes of a length-delimited
  field."""
  pos = 0
  while pos < len(buf):
    key, pos = _varint(buf, pos)
    number, wire = key >> 3, key & 7
    if wire == 0:
      value, pos = _varint(buf, pos)
    elif wire == 1:
      value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
    elif wire == 2:
      size, pos = _varint(buf, pos)
      value, pos = buf[pos:pos + size], pos + size
    elif wire == 5:
      value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
    else:
      raise ValueError(f"unsupported protobuf wire type {wire}")
    yield number, wire, value


def _int64s(feature: bytes) -> List[int]:
  out = []
  for number, wire, value in _fields(feature):
    if number != 3:  # Feature.int64_list
      continue
    for n, w, v in _fields(value):
      if n != 1:
        continue
      if w == 2:  # packed
        pos = 0
        while pos < len(v):
          x, pos = _varint(v, pos)
          out.append(x - (1 << 64) if x >> 63 else x)
      else:
        out.append(v - (1 << 64) if v >> 63 else v)
  return out


def _bytes(feature: bytes) -> bytes:
  for number, _, value in _fields(feature):
    if number == 1:  # Feature.bytes_list
      return b"".join(v for n, _, v in _fields(value) if n == 1)
  raise ValueError("feature holds no bytes_list")


def parse_example(payload: bytes) -> Dict[str, bytes]:
  """The features of a serialised ``tf.train.Example``, each as the bytes
  of its ``Feature`` message."""
  features = {}
  for number, _, value in _fields(payload):
    if number != 1:  # Example.features
      continue
    for n, _, entry in _fields(value):
      if n != 1:  # Features.feature (map entries)
        continue
      key, feature = None, b""
      for en, _, ev in _fields(entry):
        if en == 1:
          key = ev.decode("utf-8")
        elif en == 2:
          feature = ev
      features[key] = feature
  return features


def decode_image(payload: bytes) -> np.ndarray:
  """A score_sde image record -> uint8 [H, W, C] (the stored CHW
  transposed, as the JAX package's parser does)."""
  features = parse_example(payload)
  shape = _int64s(features["shape"])
  if len(shape) != 3:
    raise ValueError(f"record shape {shape}: expected 3 values")
  data = np.frombuffer(_bytes(features["data"]), np.uint8)
  return data.reshape(shape).transpose(1, 2, 0)


class TFRecordImages:
  """The images of a score_sde TFRecord file as an indexable, read-on-demand
  uint8 array [N, H, W, C]: ``images[idx]`` for an index array, ``len``.
  Every record's framing and CRCs are checked when it is read; the
  index pass checks each length's CRC."""

  def __init__(self, path: str):
    self.path = path
    self._offsets, self._lengths = [], []
    with open(path, "rb") as f:
      pos = 0
      while True:
        header = f.read(12)
        if not header:
          break
        if len(header) < 12:
          raise ValueError(f"{path}: truncated record header at {pos}")
        length, crc = struct.unpack("<QI", header)
        if masked_crc32c(header[:8]) != crc:
          raise ValueError(f"{path}: length CRC mismatch at byte {pos}")
        self._offsets.append(pos + 12)
        self._lengths.append(length)
        pos += 12 + length + 4
        f.seek(pos)
    if not self._offsets:
      raise ValueError(f"{path}: no records")
    self.shape = (len(self._offsets),) + self._read(0).shape

  def _read(self, i: int) -> np.ndarray:
    with open(self.path, "rb") as f:
      f.seek(self._offsets[i])
      payload = f.read(self._lengths[i])
      (crc,) = struct.unpack("<I", f.read(4))
    if len(payload) != self._lengths[i] or masked_crc32c(payload) != crc:
      raise ValueError(f"{self.path}: record {i}: data CRC mismatch or "
                       "truncated payload")
    return decode_image(payload)

  def __len__(self) -> int:
    return len(self._offsets)

  def __getitem__(self, idx) -> np.ndarray:
    if isinstance(idx, (int, np.integer)):
      return self._read(int(idx))
    return np.stack([self._read(int(i)) for i in np.asarray(idx)])
