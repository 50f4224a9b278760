"""Converts TFDS-materialised datasets to ArrayExample record shards.

Port of putting_dune_tpu/pipeline/import_tfds_dataset.py. Upstream
putting-dune trains its perception models from TFDS data sources:
directories of `<name>-<split>.{tfrecord,array_record}-NNNNN-of-MMMMM`
shards of serialized tf.train.Example protos, described by a
`features.json`. This converter writes them in the layout of
`io/datasets.py`, which the record-backed perception datasets read:

  python -m putting_dune_torch.pipeline.import_tfds_dataset \
      --dataset_dir=/data/tfds/atom_detection/1.0.0 \
      --output_dir=/data/records/atom_detection

tf.train.Example parses through the wire codec's ExampleCompat messages,
.array_record shards through the riegeli reader
(`io/riegeli_native.read_array_record`), .tfrecord shards through the
TFRecord codec, and PNG image features through the port's own decoder
(`io/png.py`; JPEG is not ported). Supported feature types: FeaturesDict,
Tensor (encoding none/bytes/zlib), Image (png), ClassLabel, Scalar.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

from putting_dune_torch.io import datasets as datasets_lib
from putting_dune_torch.io import png
from putting_dune_torch.io import records as records_lib
from putting_dune_torch.io import riegeli_native
from putting_dune_torch.proto import wire

_SHARD_RE = re.compile(
    r'^(?P<name>.+)-(?P<split>\w+)\.'
    r'(?P<ext>tfrecord|array_record)-\d{5}-of-\d{5}$'
)


# --- features.json -----------------------------------------------------------


class FeatureSpec:
  """One leaf feature from features.json: kind + shape + dtype (+opts)."""

  def __init__(self, kind: str, shape, dtype: str, encoding: str = 'none'):
    self.kind = kind  # 'tensor' | 'image' | 'class_label'
    self.shape = tuple(-1 if s is None else int(s) for s in (shape or ()))
    self.dtype = np.dtype(dtype)
    self.encoding = encoding

  def __repr__(self):
    return (
        f'FeatureSpec({self.kind}, shape={self.shape}, '
        f'dtype={self.dtype}, encoding={self.encoding})'
    )


def parse_features_json(path: str) -> Dict[str, FeatureSpec]:
  """Parses a TFDS features.json (the Jsonable {type, content} tree)."""
  with open(path) as f:
    tree = json.load(f)
  t = tree.get('type', '')
  if not t.endswith('FeaturesDict'):
    raise ValueError(f'{path}: top-level feature must be FeaturesDict, got {t}')
  out: Dict[str, FeatureSpec] = {}
  children = tree['content']['features']
  for name, node in children.items():
    out[name] = _parse_feature_node(name, node)
  return out


def _parse_feature_node(name: str, node) -> FeatureSpec:
  t = node.get('type', '')
  content = node.get('content', {})
  if isinstance(content, str):  # some tfds versions store content as JSON text
    content = json.loads(content)
  if t.endswith('.Image'):
    return FeatureSpec(
        'image',
        content.get('shape'),
        content.get('dtype', 'uint8'),
        content.get('encoding_format') or 'png',
    )
  if t.endswith('.Tensor') or t.endswith('.Scalar'):
    return FeatureSpec(
        'tensor',
        content.get('shape'),
        content.get('dtype'),
        (content.get('encoding') or 'none').lower(),
    )
  if t.endswith('.ClassLabel'):
    return FeatureSpec('class_label', (), 'int64')
  if t.endswith('.Text'):
    raise ValueError(f'feature {name!r}: Text features are not arrays')
  raise ValueError(f'feature {name!r}: unsupported TFDS feature type {t!r}')


# --- tf.train.Example decode -------------------------------------------------


def _resolve_shape(shape: Tuple[int, ...], count: int) -> Tuple[int, ...]:
  unknown = [i for i, s in enumerate(shape) if s < 0]
  if not unknown:
    if math.prod(shape) != count:
      raise ValueError(f'{count} elements do not fit shape {shape}')
    return shape
  if len(unknown) > 1:
    raise ValueError(f'more than one unknown dim in {shape}')
  known = math.prod(s for s in shape if s >= 0)
  if known == 0 or count % known:
    raise ValueError(f'{count} elements do not fit shape {shape}')
  resolved = list(shape)
  resolved[unknown[0]] = count // known
  return tuple(resolved)


def _decode_image(payload: bytes, spec: FeatureSpec) -> np.ndarray:
  img = png.imdecode(payload)
  if img.ndim == 2:
    img = img[..., None]
  elif img.ndim == 3 and img.shape[-1] == 3:
    # PNG decodes BGR; TFDS images are RGB on the wire.
    img = img[..., ::-1]
  return np.ascontiguousarray(img.astype(spec.dtype, copy=False))


def decode_feature(feature: wire.FeatureCompat, spec: FeatureSpec
                   ) -> np.ndarray:
  """Decodes one tf.train.Feature per its TFDS spec."""
  if spec.kind == 'image':
    return _decode_image(feature.bytes_list.value[0], spec)
  if spec.kind == 'class_label':
    return np.asarray(feature.int64_list.value[0], np.int64)
  # Tensor.
  if spec.encoding in ('bytes', 'zlib'):
    payload = feature.bytes_list.value[0]
    if spec.encoding == 'zlib':
      payload = zlib.decompress(payload)
    flat = np.frombuffer(payload, dtype=spec.dtype)
    return flat.reshape(_resolve_shape(spec.shape, flat.size)).copy()
  if spec.dtype.kind == 'f':
    flat = np.asarray(feature.float_list.value, np.float32)
  elif spec.dtype.kind in 'iub':
    flat = np.asarray(feature.int64_list.value, np.int64)
  elif spec.dtype.kind == 'S':
    raise ValueError('string tensors are not arrays')
  else:
    raise ValueError(f'unsupported tensor dtype {spec.dtype}')
  flat = flat.astype(spec.dtype, copy=False)
  return flat.reshape(_resolve_shape(spec.shape, flat.size))


def decode_example(raw: bytes, specs: Dict[str, FeatureSpec]
                   ) -> Dict[str, np.ndarray]:
  msg = wire.ExampleCompat.FromString(raw)
  out = {}
  for name, spec in specs.items():
    if name not in msg.features.feature:
      raise KeyError(f'example is missing feature {name!r}')
    out[name] = decode_feature(msg.features.feature[name], spec)
  return out


# --- shard discovery / iteration --------------------------------------------


def discover_splits(dataset_dir: str) -> Dict[str, List[str]]:
  """Maps split name -> ordered shard paths for a TFDS dataset dir."""
  splits: Dict[str, List[str]] = {}
  for path in sorted(glob.glob(os.path.join(dataset_dir, '*-of-*'))):
    m = _SHARD_RE.match(os.path.basename(path))
    if m:
      splits.setdefault(m.group('split'), []).append(path)
  if not splits:
    raise FileNotFoundError(
        f'no TFDS shards (*-<split>.tfrecord/array_record-NNNNN-of-MMMMM) '
        f'in {dataset_dir!r}'
    )
  return splits


def _iter_shard_records(path: str) -> Iterator[bytes]:
  if '.array_record-' in os.path.basename(path):
    yield from riegeli_native.read_array_record(path)
  else:
    yield from records_lib.read_tfrecords(path)


def iterate_tfds_examples(
    dataset_dir: str, split: str
) -> Iterator[Dict[str, np.ndarray]]:
  """Yields decoded {feature: array} dicts for a TFDS split."""
  specs = parse_features_json(os.path.join(dataset_dir, 'features.json'))
  shards = discover_splits(dataset_dir).get(split)
  if not shards:
    raise FileNotFoundError(f'split {split!r} not found in {dataset_dir!r}')
  for shard in shards:
    for raw in _iter_shard_records(shard):
      yield decode_example(raw, specs)


def count_tfds_examples(dataset_dir: str, split: str) -> int:
  shards = discover_splits(dataset_dir).get(split, [])
  total = 0
  for shard in shards:
    if '.array_record-' in os.path.basename(shard):
      total += len(riegeli_native.read_array_record(shard))
    else:
      total += records_lib.count_tfrecords(shard)
  return total


# --- conversion --------------------------------------------------------------


def convert(
    dataset_dir: str,
    output_dir: str,
    *,
    train_split: str = 'train',
    test_split: str = 'test',
    examples_per_shard: int = 256,
) -> Tuple[int, int]:
  """Materializes a TFDS dataset as a native ArrayExample dataset.

  Output layout matches io/datasets.py (train shards at the root, test
  under `test/`), directly consumable by the record-backed perception
  data sources. Returns (train_count, test_count).
  """
  splits = discover_splits(dataset_dir)
  n_train = count_tfds_examples(dataset_dir, train_split)
  n_test = (
      count_tfds_examples(dataset_dir, test_split)
      if test_split in splits
      else 0
  )

  def make_examples(stream: int):
    split = train_split if stream == 0 else test_split
    return iterate_tfds_examples(dataset_dir, split)

  datasets_lib.write_split_dataset(
      output_dir,
      make_examples,
      num_examples=n_train,
      test_examples=n_test,
      examples_per_shard=examples_per_shard,
  )
  return n_train, n_test


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument(
      '--dataset_dir', required=True,
      help='TFDS dataset version dir (contains features.json + shards).',
  )
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--train_split', default='train')
  parser.add_argument('--test_split', default='test')
  parser.add_argument('--examples_per_shard', type=int, default=256)
  args = parser.parse_args(argv)
  n_train, n_test = convert(
      args.dataset_dir,
      args.output_dir,
      train_split=args.train_split,
      test_split=args.test_split,
      examples_per_shard=args.examples_per_shard,
  )
  print(
      f'{args.dataset_dir} -> {args.output_dir}: '
      f'{n_train} train + {n_test} test examples'
  )


if __name__ == '__main__':
  main()
