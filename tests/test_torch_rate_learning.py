"""The port's rate learner against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in putting_dune_torch.rate_learning in one process. The
ensemble's weights are carried from the JAX package (`predictor_from_flax`)
where a test holds a deterministic function element-wise; the tolerance is
stated at each test. The samplers are held in law (threefry and Philox
streams differ).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from putting_dune_torch import kmc as t_kmc
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.rate_learning import config as t_config
from putting_dune_torch.rate_learning import data_utils as t_data
from putting_dune_torch.rate_learning import losses as t_losses
from putting_dune_torch.rate_learning import predictor as t_predictor
from putting_dune_torch.rate_learning import train as t_train
from putting_dune_torch.utils import training as t_training
from putting_dune_tpu.rate_learning import config as j_config
from putting_dune_tpu.rate_learning import data_utils as j_data
from putting_dune_tpu.rate_learning import losses as j_losses
from putting_dune_tpu.rate_learning import predictor as j_predictor
from putting_dune_tpu.rate_learning import train as j_train

torch.set_num_threads(2)

SHIPPED = os.path.join(t_eval_agent.MODEL_WEIGHTS_DIR, 'rate_predictor')
SMALL = dict(num_models=3, hidden_dimensions=(32, 16), batch_size=32,
             epochs=3)


def _t(x):
  return torch.from_numpy(np.array(x))


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=3, **kwargs):
  """A JAX predictor and the port's holding its weights."""
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(seed),
      config=j_config.RateLearningConfig(**kwargs))
  t_pred = t_predictor.predictor_from_flax(
      _np_tree(j_pred.params), _np_tree(j_pred.state),
      t_config.RateLearningConfig(**kwargs), device='cpu')
  return j_pred, t_pred


def _contexts(rng, m, b, c=4):
  return (rng.normal(size=(m, b, c)) * 2 + 1).astype(np.float32)


# --- config and model --------------------------------------------------------


def test_configs_equal_jax():
  for t_cls, j_cls in ((t_config.RateLearningConfig,
                        j_config.RateLearningConfig),
                       (t_config.DistillConfig, j_config.DistillConfig)):
    assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls())
  assert t_config.RateLearningConfig().beam_units == 'bonds'


@pytest.mark.parametrize('batchnorm', [True, False])
@pytest.mark.parametrize('num_models', [1, 3])
def test_forward_and_running_stats_match_jax(batchnorm, num_models):
  j_pred, t_pred = _pair(num_models=num_models, batchnorm=batchnorm,
                         hidden_dimensions=(32, 16))
  rng = np.random.default_rng(num_models)
  x = _contexts(rng, num_models, 64)
  apply = jax.vmap(j_pred.apply_fn, in_axes=(0, 0, None, 0, None))
  key = jax.random.PRNGKey(0)
  want_eval, _ = apply(j_pred.params, j_pred.state, key, jnp.asarray(x),
                       False)
  want_train, want_state = apply(j_pred.params, j_pred.state, key,
                                 jnp.asarray(x), True)
  got_eval = t_pred.model(_t(x), is_training=False).detach().numpy()
  got_train = t_pred.model(_t(x), is_training=True).detach().numpy()
  assert got_eval.shape == (num_models, 64, 4)
  # f32 towers of width 32: 1e-5.
  np.testing.assert_allclose(got_eval, np.asarray(want_eval), atol=1e-5)
  np.testing.assert_allclose(got_train, np.asarray(want_train), atol=1e-5)
  _, stats = t_pred.model.flax_trees()
  if batchnorm:
    for leaf in ('mean', 'var'):
      np.testing.assert_allclose(
          stats['BatchNorm_0'][leaf],
          np.asarray(want_state['BatchNorm_0'][leaf]), atol=1e-5)
    # flax's running average: 0.9 old + 0.1 batch, biased variance.
    np.testing.assert_allclose(stats['BatchNorm_0']['mean'],
                               0.1 * x.mean(1), atol=1e-5)
    np.testing.assert_allclose(stats['BatchNorm_0']['var'],
                               0.9 + 0.1 * x.var(1), atol=1e-5)
  else:
    assert stats == {} and want_state == {}


def test_initialisation_follows_flax_law():
  # lecun_normal: a normal truncated at 2 std, variance 1 / fan_in; zero
  # biases; batch-norm scale 1 and bias 0.
  t_pred = t_predictor.LearnedRatePredictor(
      config=t_config.RateLearningConfig(num_models=50,
                                         hidden_dimensions=(128, 128)),
      device='cpu', seed=1)
  params, _ = t_pred.model.flax_trees()
  kernel = params['Dense_1']['kernel']
  assert kernel.shape == (50, 128, 128)
  np.testing.assert_allclose(kernel.std(), np.sqrt(1 / 128), rtol=0.01)
  std0 = np.sqrt(1 / 128) / 0.87962566103423978
  assert np.abs(kernel).max() <= 2 * std0 + 1e-6
  j_kernel = np.asarray(jax.nn.initializers.lecun_normal()(
      jax.random.PRNGKey(0), (128, 50 * 128)))
  assert scipy.stats.ks_2samp(kernel.ravel()[:20000],
                              j_kernel.ravel()[:20000]).pvalue > 1e-3
  assert not params['Dense_0']['bias'].any()
  np.testing.assert_array_equal(params['BatchNorm_0']['scale'], 1.0)


# --- loss, gradients and the optimizer ------------------------------------------


def _batch(rng, m, b):
  next_state = rng.integers(0, 4, (m, b))
  dt = rng.uniform(0.0, 5.0, (m, b)).astype(np.float32)
  return _contexts(rng, m, b), next_state, dt


def _jax_loss_and_grads(j_pred, x, next_state, dt, weights):
  def one(p, s, x, n, d):
    return j_losses.batched_loss_fn(p, s, j_pred.apply_fn, n, d, n != 0, x,
                                    jax.random.PRNGKey(0), True, *weights)

  return jax.vmap(jax.value_and_grad(one, has_aux=True))(
      j_pred.params, j_pred.state, jnp.asarray(x), jnp.asarray(next_state),
      jnp.asarray(dt))


@pytest.mark.parametrize('weights', [(1.0, 1.0), (0.1, 1.0)])
def test_batched_loss_and_gradients_match_jax(weights):
  rng = np.random.default_rng(5)
  j_pred, t_pred = _pair(**SMALL)
  x, next_state, dt = _batch(rng, 3, 64)
  (want_loss, (want_state, want_rates, want_rate, want_class)), want_grad = (
      _jax_loss_and_grads(j_pred, x, next_state, dt, weights))
  loss, (rates, rate_loss, class_loss) = t_losses.batched_loss_fn(
      t_pred.model, _t(next_state), _t(dt), _t(next_state) != 0, _t(x), True,
      *weights)
  loss.sum().backward()
  np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                             rtol=1e-5)
  for got, want in ((rates, want_rates), (rate_loss, want_rate),
                    (class_loss, want_class)):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
  # Gradients: 1e-5 of each leaf's largest entry.
  for name, layer in t_pred.model.layers.items():
    for leaf, want in want_grad[name].items():
      got = getattr(layer, leaf).grad.numpy()
      want = np.asarray(want)
      assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (
          name, leaf)
  # The class loss only counts rows that transitioned.
  assert not class_loss.detach().numpy()[next_state == 0].any()


def test_adamw_step_matches_optax():
  rng = np.random.default_rng(6)
  config = dict(SMALL, weight_decay=0.1)
  j_pred, t_pred = _pair(**config)
  x, next_state, dt = _batch(rng, 3, 64)
  optim = optax.adamw(1e-3, weight_decay=0.1)
  params = j_pred.params
  opt_state = jax.vmap(optim.init)(params)
  optimizer = t_training.adamw(t_pred.model, 1e-3, 0.1)
  for _ in range(2):
    (_, _), grads = _jax_loss_and_grads(j_pred, x, next_state, dt, (1., 1.))
    updates, opt_state = jax.vmap(optim.update)(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    j_pred.params = params
    optimizer.zero_grad()
    loss, _ = t_losses.batched_loss_fn(
        t_pred.model, _t(next_state), _t(dt), _t(next_state) != 0, _t(x))
    loss.sum().backward()
    optimizer.step()
  got, _ = t_pred.model.flax_trees()
  for name in got:
    for leaf in got[name]:
      np.testing.assert_allclose(got[name][leaf],
                                 np.asarray(params[name][leaf]), atol=1e-6,
                                 err_msg=f'{name}.{leaf}')


# --- data -----------------------------------------------------------------------


def _transitions(seed, n=64):
  rng = np.random.default_rng(seed)
  return {
      'next_state': rng.integers(0, 4, n).astype(np.int32),
      'dt': rng.uniform(0, 5, n).astype(np.float32),
      'rates': rng.uniform(0, 1, (n, 3)).astype(np.float32),
      'position': rng.normal(size=(n, 2)).astype(np.float32),
      'context': rng.normal(size=(n, 2)).astype(np.float32),
  }


@pytest.mark.parametrize('reflect', [True, False])
def test_augment_data_matches_jax(reflect):
  data = _transitions(7)
  want = j_data.augment_data(**{k: jnp.asarray(v) for k, v in data.items()},
                             reflect=reflect)
  got = t_data.augment_data(**{k: _t(v) for k, v in data.items()},
                            reflect=reflect)
  assert len(got['next_state']) == (6 if reflect else 3) * 64
  np.testing.assert_array_equal(got['next_state'].numpy(),
                                np.asarray(want['next_state']))
  for key in ('dt', 'rates', 'context'):
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
  np.testing.assert_allclose(got['position'].numpy(),
                             np.asarray(want['position']), atol=1e-6)


def test_reflection_and_rotations_match_jax():
  ns = np.array([0, 1, 2, 3], np.int32)
  rates = np.tile(np.array([[0.1, 0.2, 0.3]], np.float32), (4, 1))
  pos = np.array([[1.0, 2.0]] * 4, np.float32)
  got = t_data.reflect_transitions(_t(ns), _t(np.ones(4)), _t(rates),
                                   _t(pos))
  assert got[0].tolist() == [0, 1, 3, 2]
  np.testing.assert_allclose(got[2].numpy()[0], [0.1, 0.3, 0.2])
  np.testing.assert_allclose(got[3].numpy()[0], [1.0, -2.0])
  p = np.random.default_rng(8).normal(size=(16, 2)).astype(np.float32)
  np.testing.assert_allclose(t_data.rotate_positions_all(_t(p)).numpy(),
                             np.asarray(j_data.rotate_positions_all(p)),
                             atol=1e-6)
  np.testing.assert_allclose(t_data.prior_rates_canonical(_t(p)).numpy(),
                             np.asarray(j_data.prior_rates_canonical(p)),
                             atol=1e-6)


def test_standardize_batched_matches_jax_with_ties_and_order():
  rng = np.random.default_rng(9)
  n = 400
  beam = rng.normal(size=(n, 2)).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, (n, 1)) + np.array([0, 2.094, 4.189])
  nbrs = (1.42 * np.stack([np.cos(angle), np.sin(angle)], -1)).astype(
      np.float32)
  # Ties: the beam on the silicon (all three neighbors at one distance) and
  # on the bisector of two neighbors.
  beam[:50] = 0.0
  beam[50:100] = 0.5 * (nbrs[50:100, 0] + nbrs[50:100, 1])
  want = j_data.standardize_batched(jnp.asarray(beam), jnp.asarray(nbrs))
  got = t_data.standardize_batched(_t(beam), _t(nbrs))
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
  np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
  # The host version is the JAX package's numpy code.
  for i in (0, 60, 200):
    host_t = t_data.standardize_beam_and_neighbors(beam[i], nbrs[i])
    host_j = j_data.standardize_beam_and_neighbors(beam[i], nbrs[i])
    for a, b in zip(host_t, host_j):
      np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2].numpy()[i], host_t[2])


@pytest.mark.parametrize('seed', [0, 11])
def test_bootstrap_and_split_give_jax_index_sets(seed):
  data = _transitions(seed, 200)
  for fn in ('bootstrap_dataset', 'split_dataset'):
    got = getattr(t_data, fn)(data, seed)
    want = getattr(j_data, fn)(data, seed)
    for g, w in zip(got, want):
      for key in data:
        np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize('bootstrap,augment,test_fraction', [
    (True, True, 0.1), (False, True, 0.2), (False, False, 0.0)])
def test_create_dataset_splits_equal_jax(bootstrap, augment, test_fraction):
  data = _transitions(12, 120)
  got = t_train.create_dataset_splits(data, 4, seed=5, bootstrap=bootstrap,
                                      augment=augment,
                                      test_fraction=test_fraction)
  want = j_train.create_dataset_splits(data, 4, seed=5, bootstrap=bootstrap,
                                       augment=augment,
                                       test_fraction=test_fraction)
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w) == ['context', 'dt', 'next_state', 'rates']
    np.testing.assert_array_equal(g['next_state'], np.asarray(w['next_state']))
    np.testing.assert_array_equal(g['dt'], np.asarray(w['dt']))
    np.testing.assert_array_equal(g['rates'], np.asarray(w['rates']))
    # The rotated positions, folded into the context: 1e-6.
    np.testing.assert_allclose(g['context'], np.asarray(w['context']),
                               atol=1e-6)
    assert g['context'].shape[:2] == g['dt'].shape


def test_prior_synthetic_data_matches_jax_in_law():
  n = 20_000
  j_train_set, _ = j_data.generate_synthetic_data(num_data=n, data_seed=3)
  t_train_set, t_test_set = t_data.generate_synthetic_data(
      num_data=n, data_seed=3, device='cpu')
  j_ns = np.asarray(j_train_set['next_state'])
  t_ns = t_train_set['next_state'].numpy()
  assert t_ns.shape == (n,) and t_test_set['dt'].shape == (n,)
  table = np.stack([np.bincount(j_ns, minlength=4),
                    np.bincount(t_ns, minlength=4)])
  assert scipy.stats.chi2_contingency(table).pvalue > 1e-3
  assert scipy.stats.ks_2samp(np.asarray(j_train_set['dt']),
                              t_train_set['dt'].numpy()).pvalue > 1e-3
  for axis in (0, 1):
    assert scipy.stats.ks_2samp(
        np.asarray(j_train_set['position'])[:, axis],
        t_train_set['position'].numpy()[:, axis]).pvalue > 1e-3
  # The stored rates are the prior's at the unrotated position, rolled by
  # the rotation (as the JAX package stores them): a permutation of the
  # prior's at the rotated one.
  rates = np.sort(t_train_set['rates'].numpy(), -1)
  want = np.sort(t_data.prior_rates_canonical(
      t_train_set['position']).numpy(), -1)
  np.testing.assert_allclose(rates, want, atol=1e-6)


def test_network_synthetic_data_shapes_and_law():
  train, _ = t_data.generate_synthetic_data(
      num_data=4000, data_seed=4,
      mode=t_data.SyntheticDataType.NETWORK, device='cpu')
  assert train['context'].shape == (4000, 2)
  assert train['position'].shape == (4000, 2)
  assert train['rates'].shape == (4000, 3) and bool(
      (train['rates'] > 0).all())
  ns = train['next_state'].numpy()
  assert set(np.unique(ns)) <= {0, 1, 2, 3} and 0.05 < (ns != 0).mean()


# --- training -------------------------------------------------------------------


def _small_data(seed, n):
  train, _ = t_data.generate_synthetic_data(
      num_data=n, data_seed=seed, device='cpu')
  return {k: v.numpy() for k, v in train.items()}


def test_ensemble_loss_falls_and_metrics_stay_on_chunks():
  data = _small_data(5, 1024)
  config = t_config.RateLearningConfig(num_models=3, batch_size=64,
                                       epochs=6, hidden_dimensions=(32, 32))
  train_sets, test_sets = t_train.create_dataset_splits(data, 3, seed=1)
  gen = torch.Generator().manual_seed(2)
  seen = []
  model, _, metrics = t_train.train_multiple_models(
      train_sets, test_sets, gen, 3, config, epoch_chunk=4,
      progress=lambda done, last: seen.append((done, last)), device='cpu')
  assert [d for d, _ in seen] == [4, 6]
  assert sorted(seen[-1][1]) == sorted(t_train.METRIC_NAMES)
  for name in t_train.METRIC_NAMES:
    assert metrics[name].shape == (3, 6)
    assert np.isfinite(metrics[name]).all()
  assert model.num_models == 3


def test_every_model_of_the_ensemble_learns():
  data = _small_data(6, 1024)
  config = t_config.RateLearningConfig(num_models=3, batch_size=64,
                                       epochs=5, hidden_dimensions=(32, 32))
  train_sets, test_sets = t_train.create_dataset_splits(data, 3, seed=2)
  gen = torch.Generator().manual_seed(3)
  model = t_train.model_lib.RateMLP(3, 4, (32, 32), generator=gen)
  rows = {k: v[:, :t_train.MAX_EVAL_ROWS]
          for k, v in t_train.to_device(train_sets, 'cpu').items()}
  with torch.no_grad():
    loss0, _ = t_losses.batched_loss_fn(
        model, rows['next_state'], rows['dt'], rows['next_state'] != 0,
        rows['context'], is_training=False)
  trained, _, metrics = t_train.train_multiple_models(
      train_sets, test_sets, gen, 3, config, device='cpu', model=model)
  assert trained is model
  assert (metrics['train_loss'][:, -1] < loss0.numpy()).all()
  assert (metrics['train_loss'][:, -1] < metrics['train_loss'][:, 0]).all()


def test_predictor_recovers_the_prior_argmax():
  # tests/test_rate_learning.py's probe: beam at the prior peak toward
  # canonical neighbor k makes k the argmax of the learned rates for at
  # least 2 of the 3 neighbors, 2 models x 60 epochs.
  data = _small_data(4, 2048)
  predictor = t_predictor.LearnedRatePredictor(
      config=t_config.RateLearningConfig(batch_size=128, epochs=60,
                                         num_models=2,
                                         hidden_dimensions=(64, 64)),
      device='cpu', seed=5)
  metrics = predictor.train(data)
  assert np.isfinite(metrics['train_loss']).all()
  hits = 0
  for k in range(3):
    angle = 2 * np.pi * k / 3
    beam = 0.85 * np.asarray([np.cos(angle), np.sin(angle)])
    x = np.concatenate([np.zeros(2), beam]).astype(np.float32)
    rates = predictor.apply_model(x[None]).numpy()
    hits += int(np.argmax(rates[0]) == k)
  assert hits >= 2, hits


def test_distillation_leaves_one_model():
  data = _small_data(8, 256)
  predictor = t_predictor.LearnedRatePredictor(
      config=t_config.RateLearningConfig(**SMALL), device='cpu', seed=9)
  predictor.train(data)
  x = np.ones((1, 4), np.float32)
  ensemble = predictor.apply_model(x).numpy()
  metrics = predictor.distill(data, t_config.DistillConfig(
      batch_size=256, epochs=50, batches_per_epoch=5))
  assert predictor.num_models == 1 and predictor.model.num_models == 1
  assert metrics['distill_loss'].shape == (50,)
  assert np.isfinite(metrics['distill_loss']).all()
  assert metrics['distill_loss'][-5:].mean() < metrics['distill_loss'][:5].mean()
  np.testing.assert_allclose(predictor.apply_model(x).numpy(), ensemble,
                             rtol=1.0, atol=0.5)


def test_distill_loss_matches_jax_on_carried_weights():
  # The same Gaussian batch through both packages' teacher-student loss.
  j_pred, t_pred = _pair(seed=4, **SMALL)
  j_student, t_student = _pair(seed=5, **dict(SMALL, num_models=1))
  rng = np.random.default_rng(3)
  mean = rng.normal(size=4).astype(np.float32)
  scale = rng.uniform(0.5, 2, 4).astype(np.float32)
  gen = torch.Generator().manual_seed(0)
  x = (torch.randn((256, 4), generator=torch.Generator().manual_seed(0))
       * _t(scale) + _t(mean))
  from putting_dune_torch.rate_learning import distill as t_distill

  t_pred_loss = t_distill.distill_loss(t_student.model, t_pred.model, gen,
                                       256, _t(mean), _t(scale))
  apply = jax.vmap(j_pred.apply_fn, in_axes=(0, 0, None, None, None))
  key = jax.random.PRNGKey(0)
  targets = j_losses.predicted_rates_to_per_neighbor(apply(
      j_pred.params, j_pred.state, key, jnp.asarray(x.numpy()), False)[0]
  ).mean(0)
  student = j_student.apply_fn(
      jax.tree_util.tree_map(lambda a: a[0], j_student.params),
      jax.tree_util.tree_map(lambda a: a[0], j_student.state), key,
      jnp.asarray(x.numpy()), True)[0]
  want = jnp.mean(jnp.sum(jnp.square(
      j_losses.predicted_rates_to_per_neighbor(student) - targets), -1))
  got = float(t_pred_loss.detach())
  np.testing.assert_allclose(got, float(want), rtol=1e-5)


# --- the predictor --------------------------------------------------------------


@pytest.fixture(scope='module')
def shipped():
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(0),
      config=j_config.RateLearningConfig(beam_units='angstroms'))
  j_pred.load(SHIPPED)
  t_pred = t_predictor.LearnedRatePredictor(
      config=t_config.RateLearningConfig(beam_units='angstroms'),
      device='cpu')
  t_pred.load(SHIPPED)
  return j_pred, t_pred


def test_shipped_predictor_loads_its_stored_config(shipped):
  _, t_pred = shipped
  with open(os.path.join(SHIPPED, 'config.json')) as f:
    stored = json.load(f)
  assert t_pred.num_models == stored['num_models_current'] == 1
  assert t_pred.config.hidden_dimensions == (128, 128)
  assert t_pred.config.num_models == 50
  assert t_pred.config.weight_decay == 0.1 and t_pred.config.batchnorm
  assert t_pred.config.beam_units == 'angstroms'


def test_shipped_rate_function_matches_jax_and_the_aligned_prior(shipped):
  j_pred, t_pred = shipped
  # The JAX test's probe: 512 beams around a canonical silicon.
  angles = np.deg2rad([0.0, 120.0, 240.0])
  nbr = (1.42 * np.stack([np.cos(angles), np.sin(angles)], -1)).astype(
      np.float32)
  beam = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (512, 2),
                                       minval=-1.8, maxval=1.8))
  si = np.zeros((512, 2), np.float32)
  nbrs = np.tile(nbr[None], (512, 1, 1))
  want = np.asarray(j_pred.as_rate_function()(si, nbrs, beam))
  got = t_pred.as_rate_function()(_t(si), _t(nbrs), _t(beam)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)
  analytic = t_rates.prior_rates_aligned(_t(si), _t(nbrs), _t(beam)).numpy()
  assert np.corrcoef(got.ravel(), analytic.ravel())[0, 1] > 0.95
  # Off-origin silicons at random lattice rotations.
  rng = np.random.default_rng(1)
  si = (rng.normal(size=(512, 2)) * 4).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, (512, 1)) + np.array([0, 2.094, 4.189])
  nbrs = (si[:, None] + 1.42 * np.stack(
      [np.cos(angle), np.sin(angle)], -1)).astype(np.float32)
  beam = (si + rng.normal(size=(512, 2))).astype(np.float32)
  want = np.asarray(j_pred.as_rate_function()(si, nbrs, beam))
  got = t_pred.as_rate_function()(_t(si), _t(nbrs), _t(beam)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)
  for i in range(3):
    np.testing.assert_allclose(
        t_pred.predict(beam[i], si[i], nbrs[i]),
        j_pred.predict(beam[i], si[i], nbrs[i]), atol=1e-5)


def test_learned_rate_function_drives_the_kmc(shipped):
  _, t_pred = shipped
  lattice = t_lattice.make_lattice(10)
  batch = 64
  offset = torch.zeros(batch, 2)
  theta = torch.zeros(batch)
  si = t_lattice.initial_silicon_index(lattice, offset)
  site = t_lattice.site_position(lattice, si, offset, theta)
  # The beam 0.85 bonds from the silicon toward +x, where the learned law
  # is large.
  beam = site + torch.tensor([1.2, 0.0])
  result = t_kmc.apply_control(
      torch.Generator().manual_seed(0), lattice, offset, theta, si, beam,
      torch.full((batch,), 5.0), t_pred.as_rate_function())
  assert result.si_index.shape == (batch,)
  moved = (result.si_index != si).float().mean()
  assert 0.1 < float(moved) and bool(
      torch.isfinite(result.num_transitions.float()).all())


@pytest.mark.parametrize('batchnorm', [True, False])
def test_checkpoints_cross_both_ways(batchnorm, tmp_path):
  config = dict(SMALL, batchnorm=batchnorm)
  t_pred = t_predictor.LearnedRatePredictor(
      config=t_config.RateLearningConfig(**config), device='cpu', seed=3)
  x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
  t_pred.save(str(tmp_path / 'port'), step=2)
  # The JAX package loads what the port wrote, into an instance built for
  # another architecture (the stored config wins).
  j_pred = j_predictor.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(1), config=j_config.RateLearningConfig())
  j_pred.load(str(tmp_path / 'port'), step=2)
  want = t_pred.apply_model(x).numpy()
  np.testing.assert_allclose(np.asarray(j_pred.apply_model(jnp.asarray(x))),
                             want, atol=1e-6)
  # And the port loads what the JAX package wrote.
  j_pred.save(str(tmp_path / 'jax'), step=0)
  back = t_predictor.LearnedRatePredictor(device='cpu')
  back.load(str(tmp_path / 'jax'))
  assert back.config == t_pred.config and back.num_models == 3
  np.testing.assert_allclose(back.apply_model(x).numpy(), want, atol=1e-6)
  for i in range(3):
    np.testing.assert_allclose(
        back.apply_model(x, model_index=i).numpy(),
        np.asarray(j_pred.apply_model(jnp.asarray(x), model_index=i)),
        atol=1e-6)
