"""The graph aligner of putting_dune_torch against the JAX package's, on
the CPU: `knn_edges` index for index (ties included), the network on the
shipped `graph_aligner` params and on JAX-initialised ones within 1e-5, one
train step (loss and metrics within 1e-5, gradients within 1e-5 of each
leaf's largest |g|, the AdamW step within 1e-6 of optax), the generator in
law, a small training run at the JAX test's bar and params.msgpack both
ways. Small widths: width 32, 2 layers, k 4, capacity 64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch.graph_alignment import data as t_data
from putting_dune_torch.graph_alignment import model as t_model
from putting_dune_torch.graph_alignment import train as t_train
from putting_dune_torch.utils import cli as t_cli
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu.graph_alignment import data as j_data
from putting_dune_tpu.graph_alignment import model as j_model
from putting_dune_tpu.graph_alignment import train as j_train

torch.set_num_threads(4)

J_LATTICE = j_lattice.make_lattice(num_cols=20)
T_LATTICE = t_lattice.make_lattice(20, 'cpu')
SMALL = dict(num_frames=2, width=32, num_layers=2, k=4)
CAPACITY = 64
FORWARD_TOL = 1e-5
METRIC_TOL = 1e-5
GRAD_TOL = 1e-5
ADAMW_TOL = 1e-6


def _leaves(tree, prefix=''):
  if isinstance(tree, dict):
    for k in sorted(tree):
      yield from _leaves(tree[k], f'{prefix}/{k}')
  else:
    yield prefix, np.asarray(tree)


def _assert_tree_close(got, want, rtol_of_max=None, atol=None):
  got, want = dict(_leaves(got)), dict(_leaves(want))
  assert sorted(got) == sorted(want)
  for name in want:
    bound = (rtol_of_max * np.abs(want[name]).max() if rtol_of_max
             else atol)
    assert np.abs(got[name] - want[name]).max() <= bound, name


def _t(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_batch(seed=1, batch_size=4, capacity=CAPACITY, **kw):
  return jax.device_get(j_data.sample_batch(
      jax.random.PRNGKey(seed), J_LATTICE, batch_size=batch_size,
      num_frames=2, capacity=capacity, **kw))


# --- knn_edges --------------------------------------------------------------------


def _lattice_cloud(n=48, jitter=0.0, masked=0, seed=0):
  """The first n canonical lattice sites: exact ties in distance."""
  pos = j_lattice.canonical_graphene_positions(10)[:n].astype(np.float32)
  rng = np.random.default_rng(seed)
  pos = pos + rng.normal(size=pos.shape).astype(np.float32) * jitter
  mask = np.ones(n, bool)
  if masked:
    mask[-masked:] = False
    pos[-masked:] = 0.0
  return pos, mask


@pytest.mark.parametrize('case', [
    dict(), dict(masked=10), dict(jitter=0.05), dict(jitter=0.05, masked=44),
    dict(n=8, masked=8)])
@pytest.mark.parametrize('k', [3, 4, 8])
def test_knn_edges_equal_jax_index_for_index(case, k):
  pos, mask = _lattice_cloud(**case)
  want = np.asarray(j_model.knn_edges(jnp.asarray(pos), jnp.asarray(mask), k))
  got = t_model.knn_edges(torch.from_numpy(pos), torch.from_numpy(mask), k)
  np.testing.assert_array_equal(got.numpy(), want)
  # Batched: the same table per graph.
  both = t_model.knn_edges(torch.from_numpy(np.stack([pos, pos])),
                           torch.from_numpy(np.stack([mask, mask])), k)
  np.testing.assert_array_equal(both.numpy(), np.stack([want, want]))


def test_knn_edges_equal_jax_on_generated_clouds():
  batch = _jax_batch(seed=3, batch_size=3)
  for b in range(3):
    want = j_model.knn_edges(batch['positions'][b], batch['mask'][b], 8)
    got = t_model.knn_edges(torch.from_numpy(batch['positions'][b]),
                            torch.from_numpy(batch['mask'][b]), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- forwards -------------------------------------------------------------------


def _jax_apply(params, batch, **arch):
  return j_model.batched_apply(j_model.AlignmentGraphNetwork(**arch),
                               params, batch)


def test_shipped_graph_aligner_matches_jax():
  params = t_train.load_params(t_model.SHIPPED_DIR)
  model = t_model.from_flax(params)
  assert (model.num_frames, model.width, len(model.layers), model.k) == (
      2, 64, 3, 8)
  batch = _jax_batch(seed=2, batch_size=3, capacity=256)
  want_g, want_l = _jax_apply(jax.tree_util.tree_map(jnp.asarray, params),
                              batch)
  with torch.no_grad():
    got_g, got_l = t_model.batched_apply(model, _t(batch))
  np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                             atol=FORWARD_TOL)
  np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                             atol=FORWARD_TOL)
  # One graph without the batch axis.
  with torch.no_grad():
    one_g, _ = model(*(torch.from_numpy(np.array(batch[k][0])) for k in (
        'positions', 'frame_ids', 'atomic_numbers', 'mask')))
  np.testing.assert_allclose(one_g.numpy(), np.asarray(want_g)[0],
                             atol=FORWARD_TOL)


def test_params_cross_both_ways():
  config = j_train.Config(workdir='', capacity=CAPACITY, **SMALL)
  params = jax.device_get(j_train.create_state(config).params)
  model = t_model.AlignmentGraphNetwork(**SMALL)
  model.load_state_dict(t_model.params_from_flax(params))
  _assert_tree_close(t_model.params_to_flax(model), params, atol=0)
  batch = _jax_batch()
  want_g, want_l = _jax_apply(params, batch, **SMALL)
  with torch.no_grad():
    got_g, got_l = t_model.batched_apply(model, _t(batch))
  np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                             atol=FORWARD_TOL)
  np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                             atol=FORWARD_TOL)


# --- one train step -----------------------------------------------------------------


@pytest.mark.parametrize('local_loss_weight', [0.0, 0.5])
def test_train_step_matches_jax(local_loss_weight):
  config = j_train.Config(workdir='', capacity=CAPACITY,
                          local_loss_weight=local_loss_weight, **SMALL)
  params = jax.device_get(j_train.create_state(config).params)
  batch = _jax_batch(seed=4)
  module = j_model.AlignmentGraphNetwork(**SMALL)
  (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(
      lambda p: j_train._loss(module, p, batch, local_loss_weight),
      has_aux=True))(params)

  t_config = t_train.Config(workdir='', capacity=CAPACITY,
                            local_loss_weight=local_loss_weight, **SMALL)
  state = t_train.create_state(t_config, device='cpu')
  state.model.load_state_dict(t_model.params_from_flax(params))
  _, metrics = t_train.train_step(state, _t(batch), local_loss_weight)
  for key in ('loss', 'drift_error'):
    assert abs(float(metrics[key]) - float(j_metrics[key])) <= METRIC_TOL
  t_grads = t_model.params_to_flax(
      {n: p.grad for n, p in state.model.named_parameters()})
  if local_loss_weight == 0:
    # The local head takes no part in the loss: zero gradients, which
    # AdamW still decays as optax does.
    assert not any(v.any() for _, v in _leaves(t_grads['_MLP_2']))
  _assert_tree_close(t_grads, jax.device_get(j_grads), rtol_of_max=GRAD_TOL)
  tx = optax.adamw(config.learning_rate)
  updates, _ = tx.update(t_grads, tx.init(params), params)
  want = jax.device_get(optax.apply_updates(params, updates))
  _assert_tree_close(t_model.params_to_flax(state.model), want,
                     atol=ADAMW_TOL)
  got_eval = t_train.eval_step(state, _t(batch))
  assert sorted(got_eval) == ['drift_error', 'loss']


# --- the generator in law -----------------------------------------------------------


def test_sample_batch_in_law():
  j = _jax_batch(seed=5, batch_size=64)
  t = {k: v.numpy() for k, v in t_data.sample_batch(
      torch.Generator().manual_seed(5), T_LATTICE, batch_size=64,
      num_frames=2, capacity=CAPACITY).items()}
  for key in j:
    assert j[key].shape == t[key].shape and j[key].dtype == t[key].dtype, key
  np.testing.assert_array_equal(t['frame_ids'], j['frame_ids'])
  np.testing.assert_allclose(t['drift'][:, -1], 0.0)
  p = scipy.stats.ks_2samp(j['drift'][:, 0].ravel(),
                           t['drift'][:, 0].ravel()).pvalue
  assert p > 1e-3, p
  # Nodes in view per frame, and silicon counts per graph.
  for stat in (lambda d: d['mask'].sum(1),
               lambda d: (d['atomic_numbers'] == 14).sum(1)):
    a, b = stat(j).astype(float), stat(t).astype(float)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= 4 * max(se, 1e-9)
  # The jitter: a node's offset from its lattice site is N(0, 0.05^2); its
  # nearest other node in the same frame stays about a bond (1.42 A) away.
  pos = t['positions'][0, :CAPACITY][t['mask'][0, :CAPACITY]]
  d = np.linalg.norm(pos[:, None] - pos[None], axis=-1) + np.eye(len(pos)) * 9
  assert 1.2 < np.median(d.min(1)) < 1.7


# --- training --------------------------------------------------------------------------


def test_training_improves_drift_error(tmp_path):
  config = t_train.Config(
      workdir=str(tmp_path), batch_size=8, epochs=2, steps_per_epoch=10,
      eval_steps=3, capacity=CAPACITY, grid_columns=20, **SMALL)
  history = []
  state = t_train.train(config, device='cpu',
                        progress=lambda e, m: history.append(m))
  assert len(history) == 2
  assert np.isfinite(history[-1]['drift_error'])
  assert history[-1]['drift_error'] < 2.0
  # The best checkpoint, then params.msgpack, read back (and into JAX).
  params = t_train.load_params(str(tmp_path))
  t_train.save_params_msgpack(state.model, str(tmp_path))
  loaded = j_train.load_params(
      str(tmp_path), j_train.Config(workdir='', capacity=CAPACITY, **SMALL))
  _assert_tree_close(jax.device_get(loaded),
                     t_model.params_to_flax(state.model), atol=0)
  assert sorted(params) == sorted(loaded)


def test_train_cli_parses_as_jax(monkeypatch):
  import sys

  from putting_dune_tpu.utils import cli as j_cli

  argv = ['--workdir=w', '--width=32', '--num_layers=2', '--k=4',
          '--capacity=64', '--local_loss_weight=0.5']
  seen = {}
  monkeypatch.setattr(sys, 'argv', ['train'] + argv)
  j_cli.run_train_cli(j_train.Config, lambda c, progress: seen.update(c=c),
                      '')
  got, _ = t_cli.parse(t_train.Config, '', argv)
  assert dataclasses.asdict(got) == dataclasses.asdict(seen['c'])
  with pytest.raises(NotImplementedError, match='IO'):
    t_train.train(dataclasses.replace(got, data_source='records:x'),
                  device='cpu')
