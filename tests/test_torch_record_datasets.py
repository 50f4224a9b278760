"""Record-backed datasets, held against the JAX package.

`write_split_dataset` / `records_iterator` give bit-equal batches to the
JAX package's with the same seed (shuffled or not, sharded over processes
or not), from shards written by either package; each perception module's
`records_dataset_iterator` reads JAX-written shards exactly; one trainer
step from `records:<dir>` equals the step on the same examples fed from
memory within 1e-5 (they are the same bits, so the two steps agree
exactly); and the three trainers run from `data_source='records:<dir>'`,
with and without a `test/` split.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from putting_dune_torch.atom_detection import data as t_det_data
from putting_dune_torch.atom_detection import train as t_det_train
from putting_dune_torch.graph_alignment import data as t_graph_data
from putting_dune_torch.graph_alignment import train as t_graph_train
from putting_dune_torch.image_alignment import data as t_align_data
from putting_dune_torch.image_alignment import train as t_align_train
from putting_dune_torch.io import datasets as t_ds
from putting_dune_tpu.atom_detection import data as j_det_data
from putting_dune_tpu.graph_alignment import data as j_graph_data
from putting_dune_tpu.image_alignment import data as j_align_data
from putting_dune_tpu.io import datasets as j_ds

STEP_TOL = 1e-5


def _toy(n, seed=0):
  rng = np.random.default_rng(seed)
  return [{'x': rng.normal(size=(2, 3)).astype(np.float32),
           'i': np.asarray([i], np.int64),
           'm': rng.random(4) > 0.5,
           'u': rng.integers(0, 255, (2,), dtype=np.uint8)}
          for i in range(n)]


def _assert_batches_equal(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert sorted(a) == sorted(b)
    for k in a:
      a_k = a[k].cpu().numpy() if isinstance(a[k], torch.Tensor) else a[k]
      assert a_k.dtype == b[k].dtype and a_k.shape == b[k].shape, k
      np.testing.assert_array_equal(a_k, b[k])


def test_examples_cross_between_the_packages():
  for example in _toy(5):
    for raw in (t_ds.example_to_bytes(example), j_ds.example_to_bytes(example)):
      for decode in (t_ds.example_from_bytes, j_ds.example_from_bytes):
        back = decode(raw)
        assert sorted(back) == sorted(example)
        for k in example:
          assert back[k].dtype == example[k].dtype
          np.testing.assert_array_equal(back[k], example[k])


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
  """The same toy dataset written by each package (train + test)."""
  root = tmp_path_factory.mktemp('toy')
  out = {}
  for name, ds in (('port', t_ds), ('jax', j_ds)):
    d = str(root / name)
    n = ds.write_split_dataset(
        d, lambda stream: iter(_toy(23 if stream == 0 else 6, seed=stream)),
        num_examples=23, test_examples=6, examples_per_shard=5)
    assert n == 23
    out[name] = d
  return out


def test_shards_are_the_same_files(dirs):
  for rel in ('part-00000.tfrecords', 'part-00004.tfrecords',
              'test/part-00001.tfrecords'):
    got = t_ds.iterate_examples(os.path.dirname(os.path.join(dirs['port'],
                                                             rel)))
    want = j_ds.iterate_examples(os.path.dirname(os.path.join(dirs['jax'],
                                                              rel)))
    _assert_batches_equal(got, want)
  assert t_ds.count_examples(dirs['jax']) == 23
  assert t_ds.shard_paths(dirs['port'])[-1].endswith('part-00004.tfrecords')


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('seed,shuffle,buffer', [(0, False, 2048),
                                                 (1, True, 2048),
                                                 (7, True, 3)])
@pytest.mark.parametrize('rank,count', [(0, 1), (1, 2), (2, 3)])
def test_records_iterator_equals_the_jax_package(dirs, writer, seed, shuffle,
                                                 buffer, rank, count):
  kwargs = dict(batch_size=3, seed=seed, shuffle=shuffle, repeat=True,
                shuffle_buffer=buffer, process_index=rank,
                process_count=count)
  got = t_ds.records_iterator(dirs[writer], **kwargs)
  want = j_ds.records_iterator(dirs[writer], **kwargs)
  # Three epochs' worth: the dropped remainder carries across epochs.
  _assert_batches_equal([next(got) for _ in range(12)],
                        [next(want) for _ in range(12)])
  once = dict(kwargs, repeat=False)
  _assert_batches_equal(t_ds.records_iterator(dirs[writer], **once),
                        j_ds.records_iterator(dirs[writer], **once))


def test_process_index_comes_from_torch_distributed(dirs, monkeypatch):
  import torch.distributed as dist

  assert t_ds.process_index_and_count() == (0, 1)
  monkeypatch.setattr(dist, 'is_initialized', lambda: True)
  monkeypatch.setattr(dist, 'get_rank', lambda: 1)
  monkeypatch.setattr(dist, 'get_world_size', lambda: 2)
  got = t_ds.records_iterator(dirs['port'], batch_size=2, shuffle=False,
                              repeat=False)
  want = j_ds.records_iterator(dirs['port'], batch_size=2, shuffle=False,
                               repeat=False, process_index=1,
                               process_count=2)
  _assert_batches_equal(got, want)


def test_split_rules(tmp_path, dirs):
  assert t_ds.split_dir(dirs['port'], 'train') == dirs['port']
  assert t_ds.split_dir(dirs['port'], 'test') == os.path.join(dirs['port'],
                                                              'test')
  with pytest.raises(FileNotFoundError, match='eval'):
    t_ds.split_dir(dirs['port'], 'eval')
  with pytest.raises(FileNotFoundError, match='part-'):
    t_ds.shard_paths(str(tmp_path))
  assert t_ds.parse_data_source('synthetic') is None
  assert t_ds.parse_data_source('') is None
  assert t_ds.parse_data_source('records:/x/y') == '/x/y'
  with pytest.raises(ValueError):
    t_ds.parse_data_source('tfds:foo')


def test_write_split_dataset_publishes_whole_datasets(tmp_path):
  d = str(tmp_path / 'ds')
  t_ds.write_split_dataset(d, lambda s: iter(_toy(4)), num_examples=4,
                           test_examples=2)
  assert os.path.isdir(os.path.join(d, 'test'))
  # A re-write without a test split leaves no stale one.
  t_ds.write_split_dataset(d, lambda s: iter(_toy(3)), num_examples=3)
  assert not os.path.isdir(os.path.join(d, 'test'))
  # A short generator publishes what it gave; an empty one keeps the old.
  assert t_ds.write_split_dataset(d, lambda s: iter(_toy(2)),
                                  num_examples=10) == 2
  with pytest.raises(ValueError, match='zero train examples'):
    t_ds.write_split_dataset(d, lambda s: iter([]), num_examples=5)
  assert t_ds.count_examples(d) == 2

  def crash(stream):
    yield from _toy(1)
    raise RuntimeError('generator died')

  with pytest.raises(RuntimeError, match='died'):
    t_ds.write_split_dataset(d, crash, num_examples=5)
  assert t_ds.count_examples(d) == 2
  assert not [p for p in os.listdir(tmp_path) if 'incoming' in p]


# --- the perception modules --------------------------------------------------


def _host(batch):
  return {k: v.cpu().numpy() for k, v in batch.items()}


def test_detection_iterator_reads_jax_written_shards(tmp_path):
  d = str(tmp_path / 'det')
  j_det_data.write_dataset(d, num_examples=8, seed=3, gen_batch_size=4,
                           image_size=32, grid_columns=20, test_examples=4,
                           examples_per_shard=4)
  for split, seed, shuffle in (('train', 0, False), ('train', 5, True),
                               ('test', 1, True)):
    got = t_det_data.records_dataset_iterator(
        d, seed, batch_size=4, split=split, shuffle=shuffle, device='cpu')
    want = j_det_data.records_dataset_iterator(
        d, seed, batch_size=4, split=split, shuffle=shuffle)
    _assert_batches_equal([next(got) for _ in range(3)],
                          [next(want) for _ in range(3)])


def _jax_write_port_examples(d, batches, num_examples):
  """Shards written by the JAX package's writer, of examples the port's
  generator made (the JAX renderer is not needed for what is tested)."""
  import itertools

  def examples(stream):
    return itertools.chain.from_iterable(
        j_ds.unbatch(_host(b)) for b in batches(stream))

  j_ds.write_split_dataset(d, examples, num_examples=num_examples,
                           test_examples=num_examples // 2,
                           examples_per_shard=3)


ALIGN = dict(image_size=32, num_frames=3, grid_columns=20)
GRAPH = dict(num_frames=2, capacity=32, grid_columns=20)


@pytest.mark.parametrize('module,j_module,kwargs', [
    (t_align_data, j_align_data, ALIGN),
    (t_graph_data, j_graph_data, GRAPH),
], ids=['image_alignment', 'graph_alignment'])
def test_alignment_iterators_read_jax_written_shards(tmp_path, module,
                                                     j_module, kwargs):
  d = str(tmp_path / 'ds')
  _jax_write_port_examples(
      d, lambda s: module.dataset_iterator(s, batch_size=2, device='cpu',
                                           **kwargs), 6)
  for split, seed in (('train', 0), ('test', 2)):
    got = module.records_dataset_iterator(d, seed, batch_size=2,
                                          split=split, device='cpu')
    want = j_module.records_dataset_iterator(d, seed, batch_size=2,
                                             split=split)
    _assert_batches_equal([next(got) for _ in range(4)],
                          [next(want) for _ in range(4)])


# --- one step from records equals one step from memory -----------------------


def _trainers(tmp_path):
  det = t_det_train.Config(workdir=str(tmp_path / 'det_w'), image_size=32,
                           batch_size=4, features=(4, 8), grid_columns=20)
  align = t_align_train.Config(workdir=str(tmp_path / 'align_w'),
                               batch_size=2, features=(4, 8), **ALIGN)
  graph = t_graph_train.Config(workdir=str(tmp_path / 'graph_w'),
                               batch_size=2, width=16, num_layers=1, k=4,
                               **GRAPH)
  return {
      'detection': (
          det, t_det_train, t_det_data,
          lambda d, seed: t_det_data.write_dataset(
              d, num_examples=8, seed=seed, gen_batch_size=4, image_size=32,
              grid_columns=20, examples_per_shard=4, device='cpu'),
          lambda seed: t_det_data.dataset_iterator(
              seed, batch_size=4, image_size=32, grid_columns=20,
              device='cpu'),
          lambda state, b: t_det_train.train_step(state, b)),
      'image_alignment': (
          align, t_align_train, t_align_data,
          lambda d, seed: t_align_data.write_dataset(
              d, num_examples=4, seed=seed, gen_batch_size=2,
              examples_per_shard=2, device='cpu', **ALIGN),
          lambda seed: t_align_data.dataset_iterator(
              seed, batch_size=2, device='cpu', **ALIGN),
          lambda state, b: t_align_train.train_step(
              state, b, align.drift_loss_weight, align.num_frames,
              align.final_step_only)),
      'graph_alignment': (
          graph, t_graph_train, t_graph_data,
          lambda d, seed: t_graph_data.write_dataset(
              d, num_examples=4, seed=seed, gen_batch_size=2,
              examples_per_shard=2, device='cpu', **GRAPH),
          lambda seed: t_graph_data.dataset_iterator(
              seed, batch_size=2, device='cpu', **GRAPH),
          lambda state, b: t_graph_train.train_step(state, b)),
  }


@pytest.mark.parametrize('name', ['detection', 'image_alignment',
                                  'graph_alignment'])
def test_one_step_from_records_equals_the_step_from_memory(tmp_path, name):
  config, train_lib, data_lib, write, stream, step = _trainers(tmp_path)[name]
  d = str(tmp_path / 'ds')
  write(d, 3)
  from_records = next(data_lib.records_dataset_iterator(
      d, 0, batch_size=config.batch_size, shuffle=False, device='cpu'))
  from_memory = next(stream(3))
  _assert_batches_equal([from_records], [_host(from_memory)])
  states = [train_lib.create_state(config, device='cpu') for _ in range(2)]
  _, m_rec = step(states[0], from_records)
  _, m_mem = step(states[1], from_memory)
  for k in m_rec:
    np.testing.assert_allclose(float(m_rec[k]), float(m_mem[k]),
                               atol=STEP_TOL)
  for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=STEP_TOL)


@pytest.mark.parametrize('name', ['detection', 'image_alignment',
                                  'graph_alignment'])
@pytest.mark.parametrize('test_split', [True, False])
def test_trainers_run_from_records(tmp_path, name, test_split):
  config, train_lib, data_lib, write, _, _ = _trainers(tmp_path)[name]
  d = str(tmp_path / 'ds')
  write(d, 0)
  if test_split:
    # A held-out split: the same layout under test/.
    write(os.path.join(d, 'test'), 9)
  history = []
  train_lib.train(dataclasses.replace(
      config, data_source=f'records:{d}', epochs=1, steps_per_epoch=2,
      eval_steps=1), device='cpu', progress=lambda e, m: history.append(m))
  assert len(history) == 1 and all(np.isfinite(v)
                                   for v in history[0].values())
  assert os.path.isdir(os.path.join(config.workdir, 'checkpoints'))
