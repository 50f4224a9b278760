"""The port's JPEG decoder (`io/jpeg.py`, `native/jpeg.cc`) against cv2.

A matrix of JPEGs made here from seeded images by cv2's and PIL's encoders
(qualities 10 / 75 / 95; 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling; grey and
colour; restart intervals; progressive; odd sizes) decodes bit-equal to
the JAX package's `_decode_image` (cv2's `imdecode(..., IMREAD_UNCHANGED)`,
flipped to RGB), through the port's `_decode_image`. A TFDS shard with
JPEG image features imports as the JAX package imports it. The kinds the
decoder refuses raise and name the ROADMAP; the EXIF orientation is not
applied, as cv2's IMREAD_UNCHANGED does not apply it; the committed
fixtures decode to their recorded pixels.
"""

import io
import itertools
import json
import os
import pathlib

import numpy as np
import pytest

from putting_dune_torch.io import datasets as t_ds
from putting_dune_torch.io import jpeg
from putting_dune_torch.io import records as t_records
from putting_dune_torch.pipeline import import_tfds_dataset as t_imp
from putting_dune_tpu.io import datasets as j_ds
from putting_dune_tpu.pipeline import import_tfds_dataset as j_imp
from putting_dune_tpu.proto import putting_dune_tpu_pb2 as pb

cv2 = pytest.importorskip('cv2')
Image = pytest.importorskip('PIL.Image')

FIXTURES = pathlib.Path(__file__).resolve().parent / 'data' / 'torch_jpeg'
SIZES = ((16, 16), (37, 53), (5, 3), (64, 9), (1, 1))


def _smooth(seed, h, w, c):
  rng = np.random.default_rng(seed)
  base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c)).astype(np.uint8)
  img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
  img = img.reshape(h, w, c)
  noise = rng.integers(-20, 20, img.shape)
  return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _spec(channels):
  return t_imp.FeatureSpec('image', [None, None, channels], 'uint8')


def _same_as_jax(data: bytes, channels: int):
  got = t_imp._decode_image(data, _spec(channels))
  want = j_imp._decode_image(data, j_imp.FeatureSpec(
      'image', [None, None, channels], 'uint8'))
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      jpeg.imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                        cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize('sampling,progressive', list(itertools.product(
    ['444', '422', '420', '440', 'grey'], [False, True])))
def test_cv2_encodings_decode_bit_equal(sampling, progressive):
  for seed, ((h, w), quality, restart) in enumerate(itertools.product(
      SIZES, (10, 75, 95), (0, 3))):
    grey = sampling == 'grey'
    img = _smooth(seed, h, w, 1 if grey else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if not grey:
      params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}')]
    ok, data = cv2.imencode('.jpg', img[..., 0] if grey else img, params)
    assert ok
    _same_as_jax(data.tobytes(), 1 if grey else 3)


@pytest.mark.parametrize('subsampling', [0, 1, 2])
@pytest.mark.parametrize('progressive', [False, True])
def test_pil_encodings_decode_bit_equal(subsampling, progressive):
  for seed, (h, w) in enumerate(SIZES):
    for quality in (10, 75, 95):
      buf = io.BytesIO()
      Image.fromarray(_smooth(seed, h, w, 3)).save(
          buf, 'JPEG', quality=quality, subsampling=subsampling,
          progressive=progressive, optimize=seed % 2 == 1)
      _same_as_jax(buf.getvalue(), 3)
  buf = io.BytesIO()
  Image.fromarray(_smooth(9, 21, 30, 1)[..., 0]).save(
      buf, 'JPEG', quality=80, progressive=progressive)
  _same_as_jax(buf.getvalue(), 1)


def test_exif_orientation_is_not_applied():
  exif = Image.Exif()
  exif[0x0112] = 6  # rotate 90
  buf = io.BytesIO()
  Image.fromarray(_smooth(3, 10, 14, 3)).save(buf, 'JPEG', quality=90,
                                              exif=exif.tobytes())
  data = buf.getvalue()
  assert jpeg.imdecode(data).shape == (10, 14, 3)
  _same_as_jax(data, 3)


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
  """data with the byte `offset` after the first `marker` set to value."""
  at = data.index(bytes([0xFF, marker]))
  out = bytearray(data)
  out[at + offset] = value
  return bytes(out)


def _baseline() -> bytes:
  ok, data = cv2.imencode('.jpg', _smooth(1, 16, 16, 3))
  return data.tobytes()


@pytest.mark.parametrize('kind,make,match', [
    ('arithmetic', lambda: _patched(_baseline(), 0xC0, 1, 0xC9),
     'arithmetic'),
    ('12-bit', lambda: _patched(_baseline(), 0xC0, 4, 12), '12-bit'),
    ('lossless', lambda: _patched(_baseline(), 0xC0, 1, 0xC3), 'lossless'),
    ('hierarchical', lambda: _patched(_baseline(), 0xC0, 1, 0xC5),
     'hierarchical'),
    ('cmyk', lambda: _cmyk(), '4-component'),
    ('4:1:1', lambda: cv2.imencode('.jpg', _smooth(2, 16, 32, 3), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes(),
     'sampling'),
])
def test_refused_kinds_raise_and_name_the_roadmap(kind, make, match):
  with pytest.raises(ValueError, match=f'{match}.*ROADMAP queue 1'):
    jpeg.imdecode(make())


def _cmyk() -> bytes:
  buf = io.BytesIO()
  Image.new('CMYK', (8, 8), (10, 20, 30, 40)).save(buf, 'JPEG')
  return buf.getvalue()


def test_malformed_jpeg_raises():
  data = _baseline()
  with pytest.raises(ValueError, match='malformed'):
    jpeg.imdecode(data[:20])
  with pytest.raises(ValueError, match='malformed'):
    jpeg.imdecode(b'\xff\xd8\xff\xd9')
  assert jpeg.is_jpeg(data) and not jpeg.is_jpeg(b'\x89PNG\r\n\x1a\n')


@pytest.mark.parametrize('name', sorted(p.stem for p in FIXTURES.glob(
    '*.jpg')))
def test_committed_fixtures_decode_to_their_pixels(name):
  data = (FIXTURES / f'{name}.jpg').read_bytes()
  np.testing.assert_array_equal(jpeg.imdecode(data),
                                np.load(FIXTURES / f'{name}.npy'))


# --- a TFDS shard with JPEG image features -------------------------------------

FEATURES_JSON = {
    'type': 'tensorflow_datasets.core.features.features_dict.FeaturesDict',
    'content': {'features': {
        'image': {
            'type': 'tensorflow_datasets.core.features.image_feature.Image',
            'content': {'shape': [None, None, 3], 'dtype': 'uint8',
                        'encoding_format': 'jpeg'}},
        'grey': {
            'type': 'tensorflow_datasets.core.features.image_feature.Image',
            'content': {'shape': [24, 20, 1], 'dtype': 'uint8',
                        'encoding_format': 'jpeg'}},
        'label': {
            'type': ('tensorflow_datasets.core.features.class_label_feature'
                     '.ClassLabel'),
            'content': {'num_classes': 4}},
    }},
}


def _example(seed) -> bytes:
  msg = pb.ExampleCompat()
  feature = msg.features.feature
  rgb = _smooth(seed, 17 + seed, 23, 3)
  ok, data = cv2.imencode('.jpg', rgb[..., ::-1], [
      cv2.IMWRITE_JPEG_QUALITY, 70 + seed, cv2.IMWRITE_JPEG_PROGRESSIVE,
      seed % 2])
  feature['image'].bytes_list.value.append(data.tobytes())
  ok, data = cv2.imencode('.jpg', _smooth(seed + 50, 24, 20, 1)[..., 0])
  feature['grey'].bytes_list.value.append(data.tobytes())
  feature['label'].int64_list.value.append(seed % 4)
  return msg.SerializeToString()


def test_tfds_import_of_jpeg_features_equals_the_jax_package(tmp_path):
  src = tmp_path / 'tfds' / 'jpegs' / '1.0.0'
  os.makedirs(src)
  (src / 'features.json').write_text(json.dumps(FEATURES_JSON))
  t_records.write_tfrecords(
      str(src / 'jpegs-train.tfrecord-00000-of-00001'),
      [_example(s) for s in range(5)])
  t_records.write_tfrecords(
      str(src / 'jpegs-test.tfrecord-00000-of-00001'),
      [_example(s) for s in range(5, 7)])
  assert t_imp.convert(str(src), str(tmp_path / 'p')) == j_imp.convert(
      str(src), str(tmp_path / 'j')) == (5, 2)
  for split in ('train', 'test'):
    got = list(t_ds.iterate_examples(t_ds.split_dir(str(tmp_path / 'p'),
                                                    split)))
    want = list(j_ds.iterate_examples(j_ds.split_dir(str(tmp_path / 'j'),
                                                     split)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
      assert sorted(g) == sorted(w)
      for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
        np.testing.assert_array_equal(g[k], w[k])
