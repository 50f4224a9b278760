"""Record-backed dataset sources for the perception trainers.

Port of putting_dune_tpu/io/datasets.py. A dataset is a directory of
sharded TFRecord files of ArrayExample records (one unbatched example per
record, named dense arrays), read and written by `io/records.py`. The
iterator streams shards with a deterministic seeded shuffle (the same
`np.random.default_rng(seed)` draws as the JAX package, so both give the
same batches) and shards examples across processes by global index, so
every process sees a disjoint slice of each epoch. The process index and
count come from `torch.distributed` when it is initialised, else 0 and 1.

Layout: a dataset directory holds `part-NNNNN.tfrecords` shards; an
optional `test/` subdirectory holds a held-out split with the same layout.
"""

from __future__ import annotations

import glob
import itertools
import logging
import os
import shutil
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from putting_dune_torch import microscope_data as md
from putting_dune_torch.io import records as records_lib
from putting_dune_torch.proto import wire

Example = Dict[str, np.ndarray]

_SHARD_GLOB = 'part-*.tfrecords'


def example_to_bytes(example: Example) -> bytes:
  """Serializes one named-array example as an ArrayExample proto."""
  return wire.ArrayExample(arrays={
      name: md.ndarray_to_proto(np.asarray(array))
      for name, array in example.items()}).SerializeToString()


def example_from_bytes(payload: bytes) -> Example:
  msg = wire.ArrayExample.FromString(payload)
  return {
      name: md.proto_to_ndarray(nd) for name, nd in msg.arrays.items()
  }


def unbatch(batch: Dict[str, np.ndarray]) -> Iterator[Example]:
  """Splits a dict of (B, ...) arrays into B per-example dicts."""
  batch = {k: np.asarray(v) for k, v in batch.items()}
  sizes = {v.shape[0] for v in batch.values()}
  if len(sizes) != 1:
    raise ValueError(f'Inconsistent leading batch dims: {sizes}')
  (size,) = sizes
  for i in range(size):
    yield {k: v[i] for k, v in batch.items()}


def write_examples(
    records_dir: str,
    examples: Iterable[Example],
    *,
    examples_per_shard: int = 256,
) -> List[str]:
  """Materializes examples as sharded TFRecord files; returns shard paths.

  Pre-existing shards in the directory are removed first: a smaller
  re-materialization must not leave stale high-numbered shards mixed
  into the new dataset. NOTE this writes IN PLACE — a crash
  mid-generation leaves a truncated dataset (and the old one already
  deleted). Dataset materialization should go through
  `write_split_dataset`, which stages into a sibling directory and
  publishes only a complete dataset.
  """
  os.makedirs(records_dir, exist_ok=True)
  for stale in glob.glob(os.path.join(records_dir, _SHARD_GLOB)):
    os.remove(stale)
  paths: List[str] = []
  pending: List[bytes] = []

  def flush():
    path = os.path.join(records_dir, f'part-{len(paths):05d}.tfrecords')
    records_lib.write_tfrecords(path, pending)
    paths.append(path)
    pending.clear()

  for example in examples:
    pending.append(example_to_bytes(example))
    if len(pending) >= examples_per_shard:
      flush()
  if pending:
    flush()
  return paths


def write_split_dataset(
    records_dir: str,
    make_examples: Callable[[int], Iterable[Example]],
    *,
    num_examples: int,
    test_examples: int = 0,
    examples_per_shard: int = 256,
) -> int:
  """Materializes a train(+test) dataset and publishes it atomically.

  `make_examples(stream)` returns an example iterable; stream 0 feeds
  the train split, stream 1 the held-out `test/` split — callers key a
  disjoint RNG off the stream index. The dataset is generated into a
  sibling staging directory and swapped into place only once COMPLETE:

    * a crash mid-generation leaves any previous dataset untouched
      instead of replacing it with a silently-truncated one that
      shard_paths/records_iterator would accept;
    * re-materializing with different parameters replaces the WHOLE
      directory, so a stale `test/` split (e.g. from an earlier
      test_examples>0 run) cannot survive to silently feed eval.

  The records_dir is owned by this layout (part-* shards + test/);
  anything else in it is replaced. Returns the number of TRAIN examples
  actually written: `num_examples` is a cap, and a finite generator that
  runs dry earlier (e.g. a short real labeled trajectory) publishes what
  it yielded — the shortfall is logged, and callers sizing epochs must
  use the return value, not the requested count.
  """
  records_dir = records_dir.rstrip('/')
  staging = f'{records_dir}.incoming-{os.getpid()}'
  retired = f'{records_dir}.retired-{os.getpid()}'
  for leftover in (staging, retired):
    if os.path.isdir(leftover):
      shutil.rmtree(leftover)

  counts = [0, 0]

  def counted(stream: int, limit: int) -> Iterator[Example]:
    for example in itertools.islice(make_examples(stream), limit):
      counts[stream] += 1
      yield example

  try:
    write_examples(
        staging,
        counted(0, num_examples),
        examples_per_shard=examples_per_shard,
    )
    if test_examples > 0:
      write_examples(
          os.path.join(staging, 'test'),
          counted(1, test_examples),
          examples_per_shard=examples_per_shard,
      )
  except BaseException:
    shutil.rmtree(staging, ignore_errors=True)
    raise
  for stream, requested, split in (
      (0, num_examples, 'train'),
      (1, test_examples, 'test'),
  ):
    if counts[stream] < requested:
      logging.warning(
          'write_split_dataset(%s): the example generator yielded only '
          '%d/%d %s examples; publishing the smaller dataset.',
          records_dir, counts[stream], requested, split,
      )
  if counts[0] == 0:
    # Never retire a good dataset in favor of an empty one: a dataset with
    # zero train shards makes every subsequent shard_paths() call raise.
    shutil.rmtree(staging, ignore_errors=True)
    raise ValueError(
        f'write_split_dataset({records_dir!r}): the example generator '
        'yielded zero train examples; refusing to publish an empty dataset '
        '(any preexisting dataset is left untouched).'
    )
  # Publish: both renames are same-filesystem (sibling paths). A crash
  # between them leaves no records_dir but the old data intact under
  # the retired name — detectable, never silently wrong.
  if os.path.exists(records_dir):
    os.rename(records_dir, retired)
  os.rename(staging, records_dir)
  shutil.rmtree(retired, ignore_errors=True)
  return counts[0]


def shard_paths(records_dir: str) -> List[str]:
  paths = sorted(glob.glob(os.path.join(records_dir, _SHARD_GLOB)))
  if not paths:
    raise FileNotFoundError(
        f'No {_SHARD_GLOB} shards under {records_dir!r} — materialize one '
        'with write_examples / the data module write_dataset helpers.'
    )
  return paths


def count_examples(records_dir: str) -> int:
  return sum(
      records_lib.count_tfrecords(p) for p in shard_paths(records_dir)
  )


def iterate_examples(records_dir: str) -> Iterator[Example]:
  """All examples in deterministic (sorted-shard, in-file) order."""
  for path in shard_paths(records_dir):
    for payload in records_lib.read_tfrecords(path):
      yield example_from_bytes(payload)


def process_index_and_count() -> tuple:
  """(rank, world size) of torch.distributed when it is initialised, else
  (0, 1)."""
  import torch.distributed as dist

  if dist.is_available() and dist.is_initialized():
    return dist.get_rank(), dist.get_world_size()
  return 0, 1


def records_iterator(
    records_dir: str,
    *,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    repeat: bool = True,
    shuffle_buffer: int = 2048,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
  """Streams stacked (local_batch, ...) dict batches from a records dir.

  Per-process sharding: examples are assigned to processes by their
  GLOBAL index (sorted-shard order) modulo process_count, which is
  stable across epochs and independent of the shuffle, so processes see
  disjoint slices. Shuffling is two-level and deterministic from `seed`:
  shard order is reshuffled each epoch and examples pass through a
  seeded reservoir buffer.

  Args:
    records_dir: directory of part-*.tfrecords shards.
    batch_size: PER-PROCESS batch size.
    seed: shuffle seed.
    shuffle: disable for deterministic evaluation sweeps.
    repeat: loop forever (train) or stop after one epoch (eval/export).
    shuffle_buffer: examples held for the second-level shuffle.
    process_index / process_count: default to torch.distributed's rank
      and world size when it is initialised, else 0 and 1.

  Yields:
    {name: (batch_size, ...) np.ndarray} batches; a final partial batch
    is dropped (drop_remainder).
  """
  if process_index is None or process_count is None:
    process_index, process_count = process_index_and_count()

  paths = shard_paths(records_dir)
  # Global index base per shard, fixed by sorted order (not shuffle
  # order); the native header scan counts without decoding payloads.
  shard_sizes = [records_lib.count_tfrecords(p) for p in paths]
  bases = np.concatenate([[0], np.cumsum(shard_sizes)])[:-1]
  rng = np.random.default_rng(seed)

  def epoch() -> Iterator[Example]:
    order = rng.permutation(len(paths)) if shuffle else np.arange(len(paths))
    buffer: List[Example] = []
    for shard_i in order:
      payloads = records_lib.read_tfrecords(paths[shard_i])
      for j, payload in enumerate(payloads):
        if (int(bases[shard_i]) + j) % process_count != process_index:
          continue
        buffer.append(example_from_bytes(payload))
        if shuffle and len(buffer) >= shuffle_buffer:
          k = int(rng.integers(len(buffer)))
          buffer[k], buffer[-1] = buffer[-1], buffer[k]
          yield buffer.pop()
        elif not shuffle:
          yield buffer.pop()
    while buffer:
      if shuffle:
        k = int(rng.integers(len(buffer)))
        buffer[k], buffer[-1] = buffer[-1], buffer[k]
      yield buffer.pop()

  pending: List[Example] = []
  while True:
    for example in epoch():
      pending.append(example)
      if len(pending) == batch_size:
        yield {
            k: np.stack([e[k] for e in pending]) for k in pending[0]
        }
        pending = []
    if not repeat:
      return
    # Dropped remainder carries into the next epoch when repeating.


def split_dir(records_dir: str, split: str) -> str:
  """Resolves a split subdirectory.

  Layout convention (module docstring): train shards live at the dataset
  ROOT, held-out splits in `<dir>/<split>/` subdirectories. 'train'
  therefore falls back to the root when no `train/` subdir exists; a
  missing held-out split is an ERROR — silently serving root (train)
  shards as eval data would invisibly inflate eval metrics and
  best-checkpoint selection.
  """
  candidate = os.path.join(records_dir, split)
  if glob.glob(os.path.join(candidate, _SHARD_GLOB)):
    return candidate
  if split == 'train':
    return records_dir
  raise FileNotFoundError(
      f'Dataset {records_dir!r} has no {split!r} split (no {_SHARD_GLOB} '
      f'under {candidate!r}). Materialize the split (write_dataset '
      'helpers write test/ alongside the train shards) or evaluate on '
      'synthetic data.'
  )


def parse_data_source(data_source: str) -> Optional[str]:
  """'records:<dir>' -> dir; 'synthetic' / '' -> None (generated data)."""
  if not data_source or data_source == 'synthetic':
    return None
  if data_source.startswith('records:'):
    return data_source[len('records:'):]
  raise ValueError(
      f'Unknown data_source {data_source!r}; expected "synthetic" or '
      '"records:<dir>".'
  )


# --- the perception data modules' helpers ------------------------------------


def write_generated(
    records_dir: str,
    make_batches: Callable[[int], Iterable[Dict]],
    *,
    num_examples: int,
    test_examples: int = 0,
    examples_per_shard: int = 256,
) -> int:
  """`write_split_dataset` over batches of tensors (or arrays) from
  `make_batches(stream)`, unbatched into examples on the host."""

  def examples(stream: int) -> Iterator[Example]:
    for batch in make_batches(stream):
      yield from unbatch({k: _host(v) for k, v in batch.items()})

  return write_split_dataset(records_dir, examples,
                             num_examples=num_examples,
                             test_examples=test_examples,
                             examples_per_shard=examples_per_shard)


def split_batches(records_dir: str, seed: int, *, batch_size: int,
                  split: str = 'train', shuffle: bool = True, device=None):
  """Endless per-process batches of a dataset's split as tensors on
  `device` (CUDA unless 'cpu'). The split is resolved now, so a missing
  held-out split raises FileNotFoundError here."""
  import torch

  from putting_dune_torch import device as device_lib

  device = device_lib.resolve_device(device)
  batches = records_iterator(split_dir(records_dir, split),
                             batch_size=batch_size, seed=seed,
                             shuffle=shuffle, repeat=True)
  return ({k: torch.as_tensor(v, device=device) for k, v in b.items()}
          for b in batches)


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)
