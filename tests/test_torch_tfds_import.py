"""TFDS dataset import: the port's PNG decoder and Example decoding.

The PNG decoder (`io/png.py`) is bit-equal to `cv2.imdecode(...,
IMREAD_UNCHANGED)` (cv2 is used on this side of the test only) for 8- and
16-bit grey, RGB and RGBA, on cv2's own encodings and on images written
with each of the five row filters. `decode_example` and `convert` give the
JAX package's arrays, exactly, on tf.train.Example shards (built with the
JAX package's wire-compatible protobuf messages) in TFRecord and
ArrayRecord containers.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest

from putting_dune_torch.io import datasets as t_ds
from putting_dune_torch.io import png
from putting_dune_torch.io import records as t_records
from putting_dune_torch.pipeline import import_tfds_dataset as t_imp
from putting_dune_tpu.io import datasets as j_ds
from putting_dune_tpu.pipeline import import_tfds_dataset as j_imp
from putting_dune_tpu.proto import putting_dune_tpu_pb2 as pb

cv2 = pytest.importorskip('cv2')

COLOR = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack('>I', len(body)) + kind + body
          + struct.pack('>I', zlib.crc32(kind + body)))


def _filter_row(kind, row, prev, bpp):
  out = bytearray(len(row))
  for x in range(len(row)):
    a = row[x - bpp] if x >= bpp else 0
    b = prev[x]
    c = prev[x - bpp] if x >= bpp else 0
    if kind == 0:
      pred = 0
    elif kind == 1:
      pred = a
    elif kind == 2:
      pred = b
    elif kind == 3:
      pred = (a + b) >> 1
    else:
      p = a + b - c
      pa, pb_, pc = abs(p - a), abs(p - b), abs(p - c)
      pred = a if pa <= pb_ and pa <= pc else (b if pb_ <= pc else c)
    out[x] = (row[x] - pred) & 0xFF
  return bytes(out)


def _encode(pixels: np.ndarray, filters) -> bytes:
  """A PNG of (H, W, C) pixels in the file's channel order (RGB), each
  row filtered by the next filter of `filters`."""
  h, w, ch = pixels.shape
  depth = pixels.dtype.itemsize * 8
  raw = pixels.astype(pixels.dtype.newbyteorder('>')).tobytes()
  stride = w * ch * depth // 8
  bpp = ch * depth // 8
  rows, prev = [], bytes(stride)
  for y in range(h):
    row = raw[y * stride:(y + 1) * stride]
    kind = filters[y % len(filters)]
    rows.append(bytes([kind]) + _filter_row(kind, row, prev, bpp))
    prev = row
  header = struct.pack('>IIBBBBB', w, h, depth, COLOR[ch], 0, 0, 0)
  return (png.SIGNATURE + _chunk(b'IHDR', header)
          + _chunk(b'IDAT', zlib.compress(b''.join(rows)))
          + _chunk(b'IEND', b''))


CASES = [(dtype, ch) for dtype in (np.uint8, np.uint16) for ch in (1, 3, 4)]


@pytest.mark.parametrize('dtype,channels', CASES,
                         ids=lambda v: getattr(v, '__name__', str(v)))
@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=lambda f: ''.join(map(str, f)))
def test_png_decoder_is_bit_equal_to_cv2(dtype, channels, filters):
  rng = np.random.default_rng(channels * 10 + len(filters))
  pixels = rng.integers(0, np.iinfo(dtype).max, (9, 11, channels),
                        endpoint=True).astype(dtype)
  pixels[2] = pixels[1]  # repeated rows exercise Up and Paeth ties
  data = _encode(pixels, filters)
  want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  got = png.imdecode(data)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype,channels', CASES,
                         ids=lambda v: getattr(v, '__name__', str(v)))
def test_png_decoder_reads_cv2_encodings(dtype, channels):
  rng = np.random.default_rng(3)
  image = rng.integers(0, np.iinfo(dtype).max, (13, 17, channels),
                       endpoint=True).astype(dtype)
  image[:, :5] = 7  # flat runs: the encoder picks other filters there
  for level in (0, 9):
    ok, data = cv2.imencode('.png', image,
                            [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    want = cv2.imdecode(data, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(png.imdecode(data.tobytes()), want)


def test_png_decoder_refuses_what_it_does_not_decode():
  ok, jpeg = cv2.imencode('.jpg', np.zeros((8, 8, 3), np.uint8))
  with pytest.raises(ValueError, match='JPEG.*ROADMAP queue 1, IO'):
    png.imdecode(jpeg.tobytes())
  with pytest.raises(ValueError, match='not a PNG'):
    png.imdecode(b'GIF89a....')
  good = _encode(np.zeros((2, 2, 1), np.uint8), [0])
  bad = bytearray(good)
  bad[-20] ^= 1  # inside the IDAT chunk
  with pytest.raises(ValueError, match='CRC'):
    png.imdecode(bytes(bad))
  palette = png.SIGNATURE + _chunk(
      b'IHDR', struct.pack('>IIBBBBB', 2, 2, 8, 3, 0, 0, 0)) + _chunk(
          b'IEND', b'')
  with pytest.raises(ValueError, match='colour type 3'):
    png.imdecode(palette)
  interlaced = png.SIGNATURE + _chunk(
      b'IHDR', struct.pack('>IIBBBBB', 2, 2, 8, 0, 0, 0, 1)) + _chunk(
          b'IEND', b'')
  with pytest.raises(ValueError, match='Interlaced'):
    png.imdecode(interlaced)


# --- tf.train.Example decoding and conversion --------------------------------

FEATURES_JSON = {
    'type': 'tensorflow_datasets.core.features.features_dict.FeaturesDict',
    'content': {'features': {
        'image': {
            'type': 'tensorflow_datasets.core.features.image_feature.Image',
            'content': {'shape': [16, 16, 1], 'dtype': 'uint8',
                        'encoding_format': 'png'}},
        'rgb': {
            'type': 'tensorflow_datasets.core.features.image_feature.Image',
            'content': {'shape': [8, 8, 3], 'dtype': 'uint8',
                        'encoding_format': 'png'}},
        'mask': {
            'type': 'tensorflow_datasets.core.features.tensor_feature.Tensor',
            'content': {'shape': [16, 16, 1], 'dtype': 'uint8',
                        'encoding': 'zlib'}},
        'drift': {
            'type': 'tensorflow_datasets.core.features.tensor_feature.Tensor',
            'content': {'shape': [2], 'dtype': 'float32'}},
        'ids': {
            'type': 'tensorflow_datasets.core.features.tensor_feature.Tensor',
            'content': {'shape': [None], 'dtype': 'int32'}},
        'num_atoms': {
            'type': ('tensorflow_datasets.core.features.class_label_feature'
                     '.ClassLabel'),
            'content': {'num_classes': 100}},
    }},
}


def _example(rng) -> bytes:
  image = rng.integers(0, 255, (16, 16, 1), dtype=np.uint8)
  rgb = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
  mask = rng.integers(0, 3, (16, 16, 1), dtype=np.uint8) * 7
  msg = pb.ExampleCompat()
  feature = msg.features.feature
  feature['image'].bytes_list.value.append(
      cv2.imencode('.png', image)[1].tobytes())
  # TFDS writes RGB; cv2.imencode takes BGR.
  feature['rgb'].bytes_list.value.append(
      cv2.imencode('.png', rgb[..., ::-1])[1].tobytes())
  feature['mask'].bytes_list.value.append(zlib.compress(mask.tobytes()))
  feature['drift'].float_list.value.extend(
      rng.standard_normal(2).astype(np.float32).tolist())
  feature['ids'].int64_list.value.extend(
      rng.integers(-5, 5, int(rng.integers(0, 4))).tolist())
  feature['num_atoms'].int64_list.value.append(int(rng.integers(0, 100)))
  return msg.SerializeToString()


def _materialize(dataset_dir, ext, n_train=7, n_test=3):
  os.makedirs(dataset_dir, exist_ok=True)
  with open(os.path.join(dataset_dir, 'features.json'), 'w') as f:
    json.dump(FEATURES_JSON, f)
  rng = np.random.default_rng(0)
  for split, n, shards in (('train', n_train, 2), ('test', n_test, 1)):
    raws = [_example(rng) for _ in range(n)]
    per = -(-n // shards)
    for s in range(shards):
      path = os.path.join(dataset_dir,
                          f'toy-{split}.{ext}-{s:05d}-of-{shards:05d}')
      chunk = raws[s * per:(s + 1) * per]
      if ext == 'array_record':
        arm = pytest.importorskip('array_record.python.array_record_module')
        writer = arm.ArrayRecordWriter(path, 'group_size:2')
        for r in chunk:
          writer.write(r)
        writer.close()
      else:
        t_records.write_tfrecords(path, chunk)


def _assert_examples_equal(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for k in w:
      assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
      np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize('ext', ['tfrecord', 'array_record'])
def test_convert_equals_the_jax_package(tmp_path, ext):
  src = str(tmp_path / 'tfds' / 'toy' / '1.0.0')
  _materialize(src, ext)
  specs = t_imp.parse_features_json(os.path.join(src, 'features.json'))
  _assert_examples_equal(t_imp.iterate_tfds_examples(src, 'train'),
                         j_imp.iterate_tfds_examples(src, 'train'))
  assert t_imp.count_tfds_examples(src, 'test') == 3
  assert t_imp.convert(src, str(tmp_path / 'p'), examples_per_shard=4) == (
      j_imp.convert(src, str(tmp_path / 'j'), examples_per_shard=4)) == (7, 3)
  for split in ('train', 'test'):
    _assert_examples_equal(
        t_ds.iterate_examples(t_ds.split_dir(str(tmp_path / 'p'), split)),
        j_ds.iterate_examples(j_ds.split_dir(str(tmp_path / 'j'), split)))
  example = next(t_imp.iterate_tfds_examples(src, 'train'))
  assert example['rgb'].shape == (8, 8, 3) and example['image'].shape == (
      16, 16, 1) and sorted(specs) == sorted(example)


def test_decode_feature_rules_equal_the_jax_package():
  spec_args = [('tensor', [None, 2], 'float32'), ('tensor', [3], 'int64'),
               ('class_label', (), 'int64')]
  f = pb.FeatureCompat()
  f.float_list.value.extend([1, 2, 3, 4, 5, 6])
  f.int64_list.value.extend([4, 5, 6])
  raw = f.SerializeToString()
  from putting_dune_torch.proto import wire

  for args in spec_args:
    got = t_imp.decode_feature(wire.FeatureCompat.FromString(raw),
                               t_imp.FeatureSpec(*args))
    want = j_imp.decode_feature(f, j_imp.FeatureSpec(*args))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  short = pb.FeatureCompat()
  short.float_list.value.extend([1, 2, 3])
  with pytest.raises(ValueError, match='do not fit'):
    t_imp.decode_feature(wire.FeatureCompat.FromString(
        short.SerializeToString()), t_imp.FeatureSpec('tensor', [None, 2],
                                                      'float32'))
  with pytest.raises(KeyError, match='missing feature'):
    t_imp.decode_example(b'', {'x': t_imp.FeatureSpec('tensor', [1],
                                                      'float32')})


def test_cli(tmp_path, capsys):
  src = str(tmp_path / 'ds')
  _materialize(src, 'tfrecord', n_train=3, n_test=1)
  t_imp.main([f'--dataset_dir={src}', f'--output_dir={tmp_path / "out"}'])
  assert '3 train + 1 test examples' in capsys.readouterr().out
  assert t_ds.count_examples(str(tmp_path / 'out')) == 3
