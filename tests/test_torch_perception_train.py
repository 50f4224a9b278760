"""The atom-detector and image-aligner trainers of putting_dune_torch
against the JAX package's, on the CPU, at small widths (features (8, 16),
32^2, 3 frames).

One step: the port's model holds JAX's `create_state` params and takes
the same numpy batch; its loss and metrics must agree within 1e-5, its
gradients within 1e-5 of each leaf's largest |g| (jax.grad of the JAX
loss), and its AdamW step within 1e-6 of optax.adamw applied to the same
gradients. The generators draw different streams (Philox against
threefry), so they are held to JAX in law (KS and z-tests at p > 1e-3),
and to the JAX tests' own property checks.
"""

import dataclasses
import datetime as dt
import json
import os
import shutil
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.special
import scipy.stats
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import microscope_data as t_md
from putting_dune_torch.atom_detection import data as t_det_data
from putting_dune_torch.atom_detection import model as t_det_model
from putting_dune_torch.atom_detection import save_model as t_det_save
from putting_dune_torch.atom_detection import train as t_det_train
from putting_dune_torch.image_alignment import data as t_align_data
from putting_dune_torch.image_alignment import model as t_align_model
from putting_dune_torch.image_alignment import save_model as t_align_save
from putting_dune_torch.image_alignment import train as t_align_train
from putting_dune_torch.io import tf_export as t_tf_export
from putting_dune_torch.utils import cli as t_cli
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import microscope_data as j_md
from putting_dune_tpu.atom_detection import data as j_det_data
from putting_dune_tpu.atom_detection import model as j_det_model
from putting_dune_tpu.atom_detection import train as j_det_train
from putting_dune_tpu.image_alignment import data as j_align_data
from putting_dune_tpu.image_alignment import model as j_align_model
from putting_dune_tpu.image_alignment import train as j_align_train
from putting_dune_tpu.utils import cli as j_cli

torch.set_num_threads(4)

SMALL = (8, 16)
SIZE = 32
FRAMES = 3
J_LATTICE = j_lattice.make_lattice(num_cols=20)
T_LATTICE = t_lattice.make_lattice(20, 'cpu')
METRIC_TOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |g|
ADAMW_TOL = 1e-6
P_MIN = 1e-3


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
    err = np.abs(got[name] - want[name]).max()
    assert err <= bound, (name, err, bound)


def _grads_by_name(model):
  return {n: p.grad for n, p in model.named_parameters()}


def _t(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _adamw_step(params, grads, lr):
  tx = optax.adamw(lr)
  updates, _ = tx.update(grads, tx.init(params), params)
  return optax.apply_updates(params, updates)


# --- one step, the detector -----------------------------------------------------


@pytest.fixture(scope='module')
def det_case():
  config = j_det_train.Config(workdir='', image_size=SIZE, features=SMALL,
                              learning_rate=1e-3)
  params = jax.device_get(j_det_train.create_state(config).params)
  batch = jax.device_get(j_det_data.sample_batch(
      jax.random.PRNGKey(3), J_LATTICE, batch_size=2, image_size=SIZE,
      noisy=True))
  return config, params, batch


@pytest.mark.parametrize('class_weights', [None, (0.2, 1.0, 10.0)])
def test_detector_train_step_matches_jax(det_case, class_weights):
  config, params, batch = det_case
  module = j_det_model.UNet(features=SMALL)

  def loss_fn(p):  # the JAX train_step's loss_fn
    logits = module.apply({'params': p}, batch['image'])
    ce = optax.softmax_cross_entropy(logits, batch['mask'])
    if class_weights is not None:
      w = jnp.einsum('...c,c->...', batch['mask'], jnp.asarray(class_weights))
      loss = jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)
    else:
      loss = jnp.mean(ce)
    acc = jnp.mean(jnp.argmax(logits, -1) == jnp.argmax(batch['mask'], -1))
    return loss, acc

  # Jitted, as the JAX train_step is: op by op, XLA's float32 sums of the
  # class-weighted CE and of the weights are each ~2e-5 from their float64
  # values on this batch; the jitted program's are not.
  (j_loss, j_acc), j_grads = jax.jit(jax.value_and_grad(
      loss_fn, has_aux=True))(params)
  # The same formula in float64 on JAX's logits.
  logits = np.asarray(module.apply({'params': params}, batch['image']),
                      np.float64)
  log_p = scipy.special.log_softmax(logits, -1)
  ce = -np.sum(batch['mask'] * log_p, -1)
  weights = batch['mask'] @ np.asarray(class_weights or (1.0, 1.0, 1.0))
  oracle = np.sum(ce * weights) / max(np.sum(weights), 1.0)

  t_config = t_det_train.Config(workdir='', image_size=SIZE, features=SMALL,
                                learning_rate=1e-3)
  state = t_det_train.create_state(t_config, device='cpu')
  state.model.load_state_dict(t_det_model.params_from_flax(params))
  _, metrics = t_det_train.train_step(state, _t(batch), class_weights)
  assert abs(float(metrics['loss']) - oracle) <= METRIC_TOL
  assert abs(float(metrics['loss']) - float(j_loss)) <= METRIC_TOL
  assert abs(float(metrics['accuracy']) - float(j_acc)) <= METRIC_TOL
  t_grads = t_det_model.params_to_flax(_grads_by_name(state.model))
  _assert_tree_close(t_grads, jax.device_get(j_grads), rtol_of_max=GRAD_TOL)
  # The AdamW step, weight decay 1e-4 included, against optax on the same
  # gradients.
  want = jax.device_get(_adamw_step(params, t_grads, 1e-3))
  _assert_tree_close(t_det_model.params_to_flax(state.model), want,
                     atol=ADAMW_TOL)
  # And the JAX train_step itself agrees on the metrics.
  _, j_metrics = j_det_train.train_step(
      j_det_train.create_state(config), batch, class_weights=class_weights)
  assert abs(float(j_metrics['loss']) - float(j_loss)) <= METRIC_TOL


def test_adamw_decay_is_optax_default():
  model = torch.nn.Linear(3, 2)
  opt = t_det_train.training.adamw(model, 0.1)
  group = opt.param_groups[0]
  assert (group['weight_decay'], group['betas'], group['eps']) == (
      1e-4, (0.9, 0.999), 1e-8)


# --- one step, the aligner ------------------------------------------------------


@pytest.fixture(scope='module')
def align_case():
  config = j_align_train.Config(workdir='', image_size=SIZE, features=SMALL,
                                num_frames=FRAMES)
  params = jax.device_get(j_align_train.create_state(config).params)
  batch = jax.device_get(j_align_data.sample_stack(
      jax.random.PRNGKey(4), J_LATTICE, batch_size=2, image_size=SIZE,
      num_frames=FRAMES, registration_noise=0.3, seed_fraction=0.5))
  return config, params, batch


@pytest.mark.parametrize('final_step_only,ce_loss_weight,drift_loss_weight',
                         [(False, 1.0, 1.0), (True, 0.5, 2.0),
                          (False, 0.0, 1.0)])
def test_aligner_train_step_matches_jax(align_case, final_step_only,
                                        ce_loss_weight, drift_loss_weight):
  config, params, batch = align_case
  module = j_align_model.GlobalLocalUNet(
      local_output_size=3 * FRAMES, global_output_size=2 * FRAMES,
      features=SMALL)

  def loss_fn(p):  # the JAX train_step's loss_fn
    ce, acc, dl, de = j_align_train._losses(
        module.apply, p, batch, FRAMES, final_step_only)
    return ce_loss_weight * ce + drift_loss_weight * dl, (ce, acc, dl, de)

  (j_total, j_aux), j_grads = jax.jit(jax.value_and_grad(
      loss_fn, has_aux=True))(params)

  t_config = t_align_train.Config(workdir='', image_size=SIZE,
                                  features=SMALL, num_frames=FRAMES)
  state = t_align_train.create_state(t_config, device='cpu')
  state.model.load_state_dict(t_align_model.params_from_flax(params))
  _, metrics = t_align_train.train_step(
      state, _t(batch), drift_loss_weight, FRAMES, final_step_only,
      ce_loss_weight)
  want = dict(zip(('ce', 'accuracy', 'drift_loss', 'drift_error'), j_aux),
              loss=j_total)
  for key, value in want.items():
    assert abs(float(metrics[key]) - float(value)) <= METRIC_TOL * max(
        1.0, abs(float(value))), key
  t_grads = t_align_model.params_to_flax(_grads_by_name(state.model))
  _assert_tree_close(t_grads, jax.device_get(j_grads), rtol_of_max=GRAD_TOL)
  want = jax.device_get(_adamw_step(params, t_grads, config.learning_rate))
  _assert_tree_close(t_align_model.params_to_flax(state.model), want,
                     atol=ADAMW_TOL)


def test_aligner_eval_step_matches_jax(align_case):
  config, params, batch = align_case
  j_state = j_align_train.create_state(config).replace(params=params)
  want = j_align_train.eval_step(j_state, batch, FRAMES, True)
  state = t_align_train.create_state(
      t_align_train.Config(workdir='', image_size=SIZE, features=SMALL,
                           num_frames=FRAMES), device='cpu')
  state.model.load_state_dict(t_align_model.params_from_flax(params))
  got = t_align_train.eval_step(state, _t(batch), FRAMES, True)
  for key in want:
    assert abs(float(got[key]) - float(want[key])) <= METRIC_TOL, key


# --- forwards after params_to_flax ----------------------------------------------


def test_detector_params_to_flax_round_trip_through_jax():
  state = t_det_train.create_state(
      t_det_train.Config(workdir='', features=SMALL, seed=5), device='cpu')
  tree = t_det_model.params_to_flax(state.model)
  x = np.random.default_rng(0).random((2, SIZE, SIZE, 1), np.float32)
  want = j_det_model.UNet(features=SMALL).apply({'params': tree}, x)
  with torch.no_grad():
    got = state.model(torch.from_numpy(x)).numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
  back = t_det_model.params_from_flax(tree)
  for key, value in state.model.state_dict().items():
    assert torch.equal(back[key], value), key


def test_aligner_params_to_flax_round_trip_through_jax():
  config = t_align_train.Config(workdir='', features=SMALL,
                                num_frames=FRAMES, seed=6)
  state = t_align_train.create_state(config, device='cpu')
  tree = t_align_model.params_to_flax(state.model)
  x = np.random.default_rng(1).random((2, SIZE, SIZE, FRAMES), np.float32)
  local, glob = j_align_model.GlobalLocalUNet(
      local_output_size=3 * FRAMES, global_output_size=2 * FRAMES,
      features=SMALL).apply({'params': tree}, x)
  with torch.no_grad():
    t_local, t_glob = state.model(torch.from_numpy(x))
  np.testing.assert_allclose(t_local.numpy(), np.asarray(local), atol=1e-5)
  np.testing.assert_allclose(t_glob.numpy(), np.asarray(glob), atol=1e-5)


def test_flax_initialisers_in_law():
  """create_state draws flax's lecun_normal kernels (transposed
  convolutions included) and zero biases; the kernels' spread per layer
  matches JAX's init within 10%."""
  t_tree = t_det_model.params_to_flax(t_det_train.create_state(
      t_det_train.Config(workdir='', features=(16, 32, 64)),
      device='cpu').model)
  j_tree = jax.device_get(j_det_train.create_state(
      j_det_train.Config(workdir='', features=(16, 32, 64))).params)
  for name, leaf in _leaves(j_tree):
    got = dict(_leaves(t_tree))[name]
    if name.endswith('bias'):
      assert not got.any() and not leaf.any(), name
    elif name.endswith('kernel'):
      assert abs(got.std() / leaf.std() - 1) < 0.1, name


# --- the generators in law ------------------------------------------------------


def _stacks(registration_noise, n=48, **kw):
  j = jax.device_get(j_align_data.sample_stack(
      jax.random.PRNGKey(11), J_LATTICE, batch_size=n, image_size=SIZE,
      num_frames=FRAMES, registration_noise=registration_noise, **kw))
  gen = torch.Generator().manual_seed(11)
  t = {k: v.numpy() for k, v in t_align_data.sample_stack(
      gen, T_LATTICE, batch_size=n, image_size=SIZE, num_frames=FRAMES,
      registration_noise=registration_noise, **kw).items()}
  return j, t


def _z(a, b):
  """z of the difference of two means."""
  se = np.sqrt(a.var() / a.size + b.var() / b.size)
  return abs(a.mean() - b.mean()) / max(se, 1e-12)


def test_raw_stacks_in_law():
  j, t = _stacks(0.0)
  for frame in range(1, FRAMES):
    p = scipy.stats.ks_2samp(j['drift'][:, frame].ravel(),
                             t['drift'][:, frame].ravel()).pvalue
    assert p > P_MIN, (frame, p)
  assert not t['drift'][:, 0].any()
  # Class shares of the masks: z of each class's share per stack.
  for c in range(3):
    share = lambda m: m.reshape(m.shape[0], -1, 3)[..., c].mean(1)  # noqa: E731
    assert _z(share(j['mask']), share(t['mask'])) < 4, c


def test_registration_stacks_in_law():
  kw = dict(seed_fraction=0.5, max_drift_per_step=1.0)
  j, t = _stacks(0.3, n=64, **kw)
  hist = lambda d: d['drift'][:, :-1].ravel()  # noqa: E731
  assert scipy.stats.ks_2samp(hist(j), hist(t)).pvalue > P_MIN
  assert scipy.stats.ks_2samp(j['drift'][:, -1].ravel(),
                              t['drift'][:, -1].ravel()).pvalue > P_MIN
  # Seeded share: stacks whose history offsets are all zero.
  seeded = lambda d: (d['drift'][:, :-1] == 0).all(axis=(1, 2))  # noqa: E731
  sj, st = seeded(j).astype(float), seeded(t).astype(float)
  assert _z(sj, st) < 4 and 0 < st.mean() < 1
  # Zero-border share of the history frames and of the final frame.
  zero = lambda d, sl: (d['images'][..., sl] == 0).mean(axis=(1, 2, 3))  # noqa: E731
  assert _z(zero(j, slice(0, -1)), zero(t, slice(0, -1))) < 4
  assert _z(zero(j, slice(-1, None)), zero(t, slice(-1, None))) < 4


def test_alignment_data_stack_properties_as_the_jax_tests_check():
  gen = torch.Generator().manual_seed(4)
  batch = t_align_data.sample_stack(gen, T_LATTICE, batch_size=2,
                                    image_size=32, num_frames=3)
  assert batch['images'].shape == (2, 32, 32, 3)
  assert batch['mask'].shape == (2, 32, 32, 9)
  assert batch['drift'].shape == (2, 3, 2)
  drift = batch['drift'].numpy()
  np.testing.assert_allclose(drift[:, 0], 0.0)
  assert (np.abs(drift[:, -1]) > 0).any()


def test_alignment_data_registration_mode_as_the_jax_tests_check():
  gen = torch.Generator().manual_seed(5)
  batch = t_align_data.sample_stack(
      gen, T_LATTICE, batch_size=4, image_size=64, num_frames=3,
      registration_noise=0.3, max_drift_per_step=1.0)
  assert batch['images'].shape == (4, 64, 64, 3)
  drift = batch['drift'].numpy()
  assert (np.abs(drift[:, :-1]) <= 0.3 + 1e-6).all()
  assert (np.abs(drift[:, -1]) <= 1.0 + 1e-6).all()
  assert (np.abs(drift[:, :-1]) > 0).any()
  images = batch['images'].numpy()
  assert (images[..., :-1] == 0).mean() > (images[..., -1] == 0).mean()
  mask = batch['mask'].numpy().reshape(4, 64, 64, 3, 3)
  for b in range(4):
    zero_cols = (images[b, :, :, 0] == 0).all(axis=0)
    if zero_cols.any():
      assert (mask[b, :, zero_cols, 0, :].argmax(-1) == 0).all()


def test_inference_preprocessing_min_max_normalizes_each_frame():
  gen = torch.Generator().manual_seed(6)
  batch = t_align_data.sample_stack(
      gen, T_LATTICE, batch_size=2, image_size=SIZE, num_frames=FRAMES,
      noisy=True, inference_preprocessing=True)
  images = batch['images'].numpy()
  np.testing.assert_allclose(images.min(axis=(1, 2)), 0.0, atol=1e-6)
  np.testing.assert_allclose(images.max(axis=(1, 2)), 1.0, atol=1e-6)


def test_mixed_noise_stream_draws_as_jax():
  """noisy_fraction's per-batch draws come from np.random.default_rng(seed)
  in both packages, so the noisy/clean sequence is the same."""
  calls = []
  real = t_align_data.sample_stack

  def spy(gen, lattice, **kwargs):
    calls.append(kwargs['noisy'])
    return real(gen, lattice, **{**kwargs, 'batch_size': 1})

  mix = np.random.default_rng(7)
  want = [bool(mix.random() < 0.5) for _ in range(8)]
  t_align_data.sample_stack = spy
  try:
    it = t_align_data.dataset_iterator(7, noisy_fraction=0.5, image_size=32,
                                       num_frames=2, grid_columns=10,
                                       device='cpu')
    for _ in range(8):
      next(it)
  finally:
    t_align_data.sample_stack = real
  assert calls == want


# --- examples from a labeled trajectory -----------------------------------------


def _trajectories(n=7, shape=(100, 100)):
  rng = np.random.default_rng(8)
  j_obs, t_obs, j_drifts, t_drifts = [], [], [], []
  for i in range(n):
    image = rng.random(shape).astype(np.float32)
    fov = ([0.0, 0.0], [20.0, 20.0])
    drift, jitter = rng.normal(size=2), np.zeros((1, 2))
    j_obs.append(j_md.MicroscopeObservation(
        grid=j_md.AtomicGrid(np.zeros((1, 2)), np.asarray([6])),
        fov=j_md.MicroscopeFieldOfView(*map(np.asarray, fov)), controls=(),
        elapsed_time=dt.timedelta(seconds=i), image=image))
    t_obs.append(t_md.MicroscopeObservation(
        grid=t_md.AtomicGrid(np.zeros((1, 2)), np.asarray([6])),
        fov=t_md.MicroscopeFieldOfView(*map(np.asarray, fov)), controls=(),
        elapsed_time=dt.timedelta(seconds=i), image=image))
    j_drifts.append(j_md.Drift(drift=drift, jitter=jitter))
    t_drifts.append(t_md.Drift(drift=drift, jitter=jitter))
  return (j_md.LabeledAlignmentTrajectory(j_md.Trajectory(tuple(j_obs)),
                                          tuple(j_drifts)),
          t_md.LabeledAlignmentTrajectory(t_md.Trajectory(tuple(t_obs)),
                                          tuple(t_drifts)))


@pytest.mark.parametrize('inference_preprocessing', [False, True])
@pytest.mark.parametrize('shape', [(100, 100), (131, 97)])
def test_examples_from_labeled_trajectory_equal_jax(inference_preprocessing,
                                                    shape):
  j_traj, t_traj = _trajectories(shape=shape)
  kw = dict(num_frames=FRAMES, image_size=64, stride=2,
            inference_preprocessing=inference_preprocessing)
  want = list(j_align_data.examples_from_labeled_trajectory(j_traj, **kw))
  got = list(t_align_data.examples_from_labeled_trajectory(
      t_traj, device='cpu', **kw))
  assert len(got) == len(want) == 3
  for g, w in zip(got, want):
    for key in ('images', 'mask', 'drift'):
      assert g[key].dtype == w[key].dtype == np.float32
      np.testing.assert_allclose(g[key], w[key], atol=1e-5)


# --- small end-to-end runs at the JAX tests' bars -------------------------------


def test_detection_training_learns_and_warm_starts(tmp_path):
  config = t_det_train.Config(
      workdir=str(tmp_path), batch_size=8, epochs=2, steps_per_epoch=8,
      eval_steps=2, image_size=32, features=SMALL, grid_columns=20)
  history = []
  t_det_train.train(config, device='cpu',
                    progress=lambda e, m: history.append(m))
  assert len(history) == 2
  assert history[-1]['loss'] < 1.0
  assert history[-1]['accuracy'] > 0.5
  params = t_det_train.load_params(str(tmp_path), config)
  # Warm start: a fresh workdir with no checkpoints picks up the params.
  t_det_train.save_params_msgpack(params, str(tmp_path))
  shutil.rmtree(tmp_path / 'checkpoints')
  cont_dir = tmp_path / 'continue'
  cont_dir.mkdir()
  cont = dataclasses.replace(config, workdir=str(cont_dir), epochs=0,
                             init_params_from=str(tmp_path))
  state = t_det_train.train(cont, device='cpu')
  _assert_tree_close(t_det_model.params_to_flax(state.model), params, atol=0)


def test_alignment_training_reduces_drift_error(tmp_path):
  config = t_align_train.Config(
      workdir=str(tmp_path), batch_size=8, epochs=2, steps_per_epoch=8,
      eval_steps=2, image_size=32, num_frames=3, features=SMALL,
      grid_columns=20)
  history = []
  t_align_train.train(config, device='cpu',
                      progress=lambda e, m: history.append(m))
  assert len(history) == 2
  assert np.isfinite(history[-1]['drift_error'])
  assert history[-1]['drift_error'] < 5.0
  assert sorted(history[-1]) == ['accuracy', 'ce', 'drift_error',
                                 'drift_loss']


def test_eval_steps_zero_falls_back_to_train_metrics(tmp_path):
  config = t_align_train.Config(
      workdir=str(tmp_path), batch_size=2, epochs=1, steps_per_epoch=1,
      eval_steps=0, image_size=32, num_frames=2, features=SMALL,
      grid_columns=10)
  history = []
  t_align_train.train(config, device='cpu',
                      progress=lambda e, m: history.append(m))
  assert sorted(history[0]) == ['accuracy', 'ce', 'drift_error',
                                'drift_loss', 'loss']
  det = t_det_train.Config(workdir=str(tmp_path / 'det'), batch_size=2,
                           epochs=1, steps_per_epoch=0, eval_steps=1,
                           image_size=32, features=SMALL, grid_columns=10)
  history = []
  t_det_train.train(det, device='cpu', progress=lambda e, m: history.append(m))
  assert sorted(history[0]) == ['accuracy']
  with pytest.raises(ValueError, match='cannot both be 0'):
    t_det_train.train(dataclasses.replace(det, steps_per_epoch=0,
                                          eval_steps=0), device='cpu')


@pytest.mark.parametrize('module', [t_det_train, t_align_train])
def test_records_source_and_default_device(module, tmp_path):
  # A records source is read (tests/test_torch_record_datasets.py trains
  # from one); a directory without shards raises when the first batch is
  # drawn, an unknown source at once.
  config = module.Config(workdir=str(tmp_path / 'w'),
                         data_source=f'records:{tmp_path / "none"}')
  with pytest.raises(FileNotFoundError, match='part-'):
    module.train(config, device='cpu')
  with pytest.raises(ValueError, match='data_source'):
    module.train(dataclasses.replace(config, data_source='tfds:x'),
                 device='cpu')
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      module.create_state(module.Config(workdir=str(tmp_path)))


# --- weights across -------------------------------------------------------------


def test_port_params_load_in_jax_and_jax_params_load_in_the_port(tmp_path):
  # Port -> JAX: save_params_msgpack's bytes through flax.from_bytes.
  state = t_align_train.create_state(
      t_align_train.Config(workdir='', features=SMALL, num_frames=FRAMES,
                           seed=2), device='cpu')
  config = t_align_train.Config(workdir=str(tmp_path), features=SMALL,
                                num_frames=FRAMES, image_size=SIZE)
  t_align_train.save_params_msgpack(state.model, str(tmp_path), config)
  j_config = j_align_train.Config(workdir=str(tmp_path), features=SMALL,
                                  num_frames=FRAMES, image_size=SIZE)
  loaded = j_align_train.load_params(str(tmp_path), j_config)
  _assert_tree_close(jax.device_get(loaded),
                     t_align_model.params_to_flax(state.model), atol=0)
  with open(tmp_path / 'arch.json') as f:
    assert json.load(f) == {'features': list(SMALL), 'num_frames': FRAMES,
                            'image_size': SIZE}
  # JAX -> port, and the bytes are the JAX package's own.
  j_dir = tmp_path / 'jax'
  j_dir.mkdir()
  j_params = jax.device_get(j_det_train.create_state(
      j_det_train.Config(workdir='', features=SMALL)).params)
  j_det_train.save_params_msgpack(j_params, str(j_dir))
  got = t_det_train.load_params(str(j_dir))
  _assert_tree_close(got, j_params, atol=0)
  t_dir = tmp_path / 'port'
  t_dir.mkdir()
  t_det_train.save_params_msgpack(got, str(t_dir))
  assert (t_dir / 'params.msgpack').read_bytes() == (
      j_dir / 'params.msgpack').read_bytes()
  flax.serialization.from_bytes(j_params,
                                (t_dir / 'params.msgpack').read_bytes())


def test_save_model_clis_write_the_jax_keys(tmp_path, capsys):
  det_dir = tmp_path / 'det'
  det_dir.mkdir()
  state = t_det_train.create_state(
      t_det_train.Config(workdir='', features=SMALL), device='cpu')
  t_det_train.save_params_msgpack(state.model, str(det_dir))
  t_det_save.main([f'--workdir={det_dir}', f'--output_dir={tmp_path}/a',
                   '--features', '8', '16', '--image_size=32'])
  with open(tmp_path / 'a' / 'model.json') as f:
    assert json.load(f) == {'kind': 'atom_detection_unet',
                            'features': [8, 16], 'image_size': 32,
                            'num_classes': 3}
  assert (tmp_path / 'a' / 'params.msgpack').read_bytes() == (
      det_dir / 'params.msgpack').read_bytes()
  align_dir = tmp_path / 'align'
  align_dir.mkdir()
  state = t_align_train.create_state(
      t_align_train.Config(workdir='', features=SMALL, num_frames=FRAMES),
      device='cpu')
  t_align_train.save_params_msgpack(state.model, str(align_dir))
  t_align_save.main([f'--workdir={align_dir}', f'--output_dir={tmp_path}/b',
                     '--num_frames=3', '--features', '8', '16'])
  with open(tmp_path / 'b' / 'model.json') as f:
    assert json.load(f) == {'kind': 'global_local_unet', 'features': [8, 16],
                            'image_size': 128, 'num_frames': 3}
  # --export_tf writes <output_dir>/tf_saved_model, which the port's loader
  # runs to the network's own outputs (TF loads it too:
  # tests/test_torch_tf_interop_unets.py).
  capsys.readouterr()
  for main, workdir, shape, extra in (
      (t_det_save.main, det_dir, (1, 32, 32, 1), []),
      (t_align_save.main, align_dir, (1, 32, 32, FRAMES),
       [f'--num_frames={FRAMES}'])):
    out = tmp_path / f'{workdir.name}_tf'
    main([f'--workdir={workdir}', f'--output_dir={out}', '--image_size=32',
          '--features', '8', '16', '--export_tf', '--device=cpu', *extra])
    assert capsys.readouterr().out.splitlines() == [
        f'Saved native artifact to {out}', 'Exported TF SavedModel.']
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    loaded = t_tf_export.load_tf_saved_model(str(out / 'tf_saved_model'),
                                             device='cpu')(x)
    if main is t_det_save.main:
      module = t_det_model.UNet(features=SMALL)
      module.load_state_dict(t_det_model.params_from_flax(
          t_det_train.load_params(str(workdir))))
      with torch.no_grad():
        want = (module.eval()(torch.from_numpy(x)),)
      loaded = (loaded,)
    else:
      with torch.no_grad():
        want = t_align_model.from_flax(t_align_train.load_params(
            str(workdir)))(torch.from_numpy(x))
    for got, ref in zip(loaded, want, strict=True):
      torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# --- the train CLIs -------------------------------------------------------------


TRAIN_ARGVS = [
    ['--workdir=w'],
    ['--workdir=w', '--epochs=2', '--steps_per_epoch=3', '--eval_steps=1',
     '--features=64,128,256', '--class_weights=0.2,1,10', '--noisy_images',
     '--learning_rate=1e-4', '--seed=13', '--init_params_from=x'],
    ['--workdir=w', '--no-noisy_images', '--image_size=256',
     '--batch_size=32'],
]
ALIGN_ARGVS = [
    ['--workdir=w', '--registration_noise=0.35', '--inference_preprocessing',
     '--seed_fraction=0.25', '--features=64,128,256,512', '--final_step_only',
     '--ce_loss_weight=0'],
]


def _jax_config(monkeypatch, config_cls, argv):
  seen = {}
  monkeypatch.setattr(sys, 'argv', ['train'] + argv)
  j_cli.run_train_cli(config_cls, lambda c, progress: seen.update(c=c), '')
  return seen['c']


@pytest.mark.parametrize('pair,argv', [
    *[((j_det_train.Config, t_det_train.Config), a) for a in TRAIN_ARGVS],
    *[((j_align_train.Config, t_align_train.Config), a) for a in ALIGN_ARGVS],
])
def test_train_cli_parses_as_jax(monkeypatch, pair, argv):
  j_cls, t_cls = pair
  want = dataclasses.asdict(_jax_config(monkeypatch, j_cls, argv))
  got, device = t_cli.parse(t_cls, '', argv + ['--device=cpu'])
  assert device == 'cpu'
  assert dataclasses.asdict(got) == want


def test_train_cli_parses_noisy_fraction_as_a_number(monkeypatch):
  """The JAX CLI hands an Optional[float] on as a string (and its data
  iterator then fails to compare it); the port parses the number."""
  argv = ['--workdir=w', '--noisy_fraction=0.4']
  want = _jax_config(monkeypatch, j_det_train.Config, argv)
  got, _ = t_cli.parse(t_det_train.Config, '', argv)
  assert want.noisy_fraction == '0.4' and got.noisy_fraction == 0.4


def test_train_cli_refuses_multi_process_flags():
  # The three flags now join a torch.distributed world together; one of
  # them alone is refused before any group forms.
  for flag in ('--coordinator_address=localhost:1', '--num_processes=2',
               '--process_id=0'):
    with pytest.raises(ValueError, match='go together'):
      t_cli.run_train_cli(t_det_train.Config, t_det_train.train, '',
                          ['--workdir=w', '--device=cpu', flag])
  assert not torch.distributed.is_initialized()


def test_train_cli_runs_a_trainer(tmp_path, capsys):
  state = t_cli.run_train_cli(
      t_det_train.Config, t_det_train.train, '',
      [f'--workdir={tmp_path}', '--epochs=1', '--steps_per_epoch=1',
       '--eval_steps=1', '--batch_size=2', '--image_size=32',
       '--features=8,16', '--grid_columns=10', '--device=cpu'])
  assert 'epoch 0: loss=' in capsys.readouterr().out
  assert os.path.isdir(tmp_path / 'checkpoints' / '0')
  assert isinstance(state.model, t_det_model.UNet)
