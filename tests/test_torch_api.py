"""The port's public API against the JAX package's, member by member.

Field of view geometry (`offset`, `shift`, `resize`, `zoom`), the optional
beam settings of `BeamControl`, the simulator's `last_controls`,
`TimeStep.last`, the env's specs and the feature constructors' specs: each
built from the same numpy inputs in both packages and compared (float32,
atol 1e-6, exact where the value is a copy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import simulator as t_sim
from putting_dune_torch import structures as t_struct
from putting_dune_torch.env import action_adapters as t_adapters
from putting_dune_torch.env import env as t_env
from putting_dune_torch.env import features as t_features
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu import simulator as j_sim
from putting_dune_tpu import structures as j_struct
from putting_dune_tpu.env import action_adapters as j_adapters
from putting_dune_tpu.env import env as j_env
from putting_dune_tpu.env import features as j_features

torch.set_num_threads(2)

ATOL = 1e-6


def _fovs(batch=5, seed=0):
  rng = np.random.default_rng(seed)
  lower = rng.uniform(-20.0, 20.0, (batch, 2)).astype(np.float32)
  upper = lower + rng.uniform(5.0, 30.0, (batch, 2)).astype(np.float32)
  return (j_struct.FieldOfView(jnp.asarray(lower), jnp.asarray(upper)),
          t_struct.FieldOfView(torch.from_numpy(lower),
                               torch.from_numpy(upper)))


def _same_fov(t_fov, j_fov):
  for name in ('lower_left', 'upper_right'):
    np.testing.assert_allclose(getattr(t_fov, name).numpy(),
                               np.asarray(getattr(j_fov, name)),
                               atol=ATOL, rtol=0)


def test_field_of_view_offset_shift_resize_zoom_match_jax():
  j_fov, t_fov = _fovs()
  np.testing.assert_allclose(t_fov.offset.numpy(), np.asarray(j_fov.offset),
                             atol=ATOL, rtol=0)
  rng = np.random.default_rng(1)
  delta = rng.uniform(-3.0, 3.0, (5, 2)).astype(np.float32)
  _same_fov(t_fov.shift(torch.from_numpy(delta)),
            j_fov.shift(jnp.asarray(delta)))
  # A scalar size broadcasts over the batch; per-env sizes go through as is.
  _same_fov(t_fov.resize(12.0, 7.5), j_fov.resize(12.0, 7.5))
  widths = rng.uniform(4.0, 40.0, 5).astype(np.float32)
  heights = rng.uniform(4.0, 40.0, 5).astype(np.float32)
  _same_fov(t_fov.resize(torch.from_numpy(widths), torch.from_numpy(heights)),
            j_fov.resize(jnp.asarray(widths), jnp.asarray(heights)))
  _same_fov(t_fov.zoom(2.5), j_fov.zoom(2.5))
  factors = rng.uniform(0.5, 4.0, 5).astype(np.float32)
  zoomed = t_fov.zoom(torch.from_numpy(factors))
  _same_fov(zoomed, j_fov.zoom(jnp.asarray(factors)))
  # Resizing keeps the centre.
  np.testing.assert_allclose(zoomed.offset.numpy(), t_fov.offset.numpy(),
                             atol=ATOL, rtol=0)


def test_beam_control_voltage_and_current_match_jax():
  rng = np.random.default_rng(2)
  position = rng.uniform(0.0, 1.0, (4, 2)).astype(np.float32)
  dwell = rng.uniform(1.0, 5.0, 4).astype(np.float32)
  volts = rng.uniform(60.0, 100.0, 4).astype(np.float32)
  amps = rng.uniform(0.01, 0.1, 4).astype(np.float32)
  j_plain = j_struct.BeamControl(jnp.asarray(position), jnp.asarray(dwell))
  t_plain = t_struct.BeamControl(torch.from_numpy(position),
                                 torch.from_numpy(dwell))
  assert j_plain.voltage_kv is None and j_plain.current_na is None
  assert t_plain.voltage_kv is None and t_plain.current_na is None
  j_full = j_plain.replace(voltage_kv=jnp.asarray(volts),
                           current_na=jnp.asarray(amps))
  t_full = dataclasses.replace(t_plain, voltage_kv=torch.from_numpy(volts),
                               current_na=torch.from_numpy(amps))
  for name in ('position', 'dwell_seconds', 'voltage_kv', 'current_na'):
    np.testing.assert_array_equal(getattr(t_full, name).numpy(),
                                  np.asarray(getattr(j_full, name)))
  # Leafwise maps skip the unset settings, as jax.tree_util does.
  j_doubled = jax.tree_util.tree_map(lambda x: 2 * x, j_plain)
  t_doubled = t_struct.tree_map(lambda x: 2 * x, t_plain)
  assert t_doubled.voltage_kv is None and j_doubled.voltage_kv is None
  np.testing.assert_array_equal(t_doubled.position.numpy(),
                                np.asarray(j_doubled.position))


def test_simulator_reports_last_controls_as_jax_does():
  batch = 6
  j_lat, t_lat = j_lattice.make_lattice(50), t_lattice.make_lattice(50)
  j_state, j_obs = j_sim.reset(jax.random.PRNGKey(0), j_lat,
                               batch_size=batch)
  t_state, t_obs = t_sim.reset(torch.Generator().manual_seed(0), t_lat,
                               batch_size=batch)
  assert j_obs.last_controls is None and t_obs.last_controls is None
  rng = np.random.default_rng(3)
  position = rng.uniform(0.3, 0.7, (batch, 2)).astype(np.float32)
  dwell = np.full(batch, 1.5, np.float32)
  _, j_obs, _ = j_sim.step(
      j_state, jax.random.PRNGKey(1),
      j_struct.BeamControl(jnp.asarray(position), jnp.asarray(dwell)),
      j_lat, j_rates.simple_canonical_rates)
  _, t_obs, _ = t_sim.step(
      t_state, torch.Generator().manual_seed(1),
      t_struct.BeamControl(torch.from_numpy(position),
                           torch.from_numpy(dwell)),
      t_lat, t_rates.simple_canonical_rates)
  # The microscope-frame controls as given, in both.
  for name in ('position', 'dwell_seconds'):
    np.testing.assert_array_equal(
        getattr(t_obs.last_controls, name).numpy(),
        np.asarray(getattr(j_obs.last_controls, name)))
  assert t_obs.last_controls.voltage_kv is None
  assert j_obs.last_controls.voltage_kv is None


@pytest.mark.parametrize('finished', [2, 6])
def test_env_steps_through_resets_with_last_controls_cleared(finished):
  """The env drops the stepped observation's controls before it mixes in
  fresh episodes' observations (which have none), as the JAX env does: the
  compacted reset (2 of 6 envs) and the full-batch one (6 of 6)."""
  env = t_env.PuttingDuneEnv(
      rate_fn=t_rates.simple_canonical_rates, batch_size=6, device='cpu',
      config=t_env.EnvConfig(reset_chunk=4))
  gen = torch.Generator().manual_seed(4)
  state, _ = env.reset(gen)
  needs = torch.zeros(6, dtype=torch.bool)
  needs[:finished] = True
  state = dataclasses.replace(state, needs_reset=needs)
  state, ts = env.step(state, torch.zeros((6, 2)), gen)
  assert torch.equal(ts.first(), needs)
  assert torch.isfinite(ts.observation).all()


def test_timestep_last_matches_jax():
  step_type = np.array([0, 1, 2, 2, 1, 0], np.int32)
  zeros = np.zeros(6, np.float32)
  j_ts = j_env.TimeStep(jnp.asarray(step_type), jnp.asarray(zeros),
                        jnp.asarray(zeros), None, jnp.asarray(zeros))
  t_ts = t_env.TimeStep(torch.from_numpy(step_type), torch.from_numpy(zeros),
                        torch.from_numpy(zeros), None,
                        torch.from_numpy(zeros))
  np.testing.assert_array_equal(t_ts.last().numpy(), np.asarray(j_ts.last()))
  np.testing.assert_array_equal(t_ts.first().numpy(),
                                np.asarray(j_ts.first()))


def _spec_tuple(spec):
  if isinstance(spec, dict):
    return {k: dataclasses.astuple(v) for k, v in spec.items()}
  return dataclasses.astuple(spec)


@pytest.mark.parametrize('adapter,features', [
    ('relative', 'pristine'), ('material', 'material'), ('relative', 'image')])
def test_env_specs_match_jax(adapter, features):
  adapters = {
      'relative': (j_adapters.RelativeToSiliconActionAdapter(),
                   t_adapters.RelativeToSiliconActionAdapter()),
      'material': (
          j_adapters.RelativeToSiliconMaterialFrameActionAdapter(
              min_dwell_seconds=1.0, max_dwell_seconds=5.0),
          t_adapters.RelativeToSiliconMaterialFrameActionAdapter(
              min_dwell_seconds=1.0, max_dwell_seconds=5.0)),
  }[adapter]
  constructors = {
      'pristine': (j_features.SingleSiliconPristineGrapheneFeatures(),
                   t_features.SingleSiliconPristineGrapheneFeatures()),
      'material': (j_features.SingleSiliconMaterialFrameFeatures(),
                   t_features.SingleSiliconMaterialFrameFeatures()),
      'image': (j_features.ImageFeatures(image_size=64),
                t_features.ImageFeatures(image_size=64)),
  }[features]
  j_e = j_env.PuttingDuneEnv(lattice=j_lattice.make_lattice(10),
                             adapter=adapters[0], features=constructors[0])
  t_e = t_env.PuttingDuneEnv(lattice=t_lattice.make_lattice(10),
                             adapter=adapters[1], features=constructors[1],
                             device='cpu')
  assert dataclasses.astuple(t_e.action_spec()) == dataclasses.astuple(
      j_e.action_spec())
  assert _spec_tuple(t_e.observation_spec()) == _spec_tuple(
      j_e.observation_spec())


@pytest.mark.parametrize('name,kwargs', [
    ('SingleSiliconPristineGrapheneFeatures', {}),
    ('SingleSiliconMaterialFrameFeatures', {}),
    ('ImageFeatures', {}), ('ImageFeatures', {'image_size': 256})])
def test_feature_specs_match_jax(name, kwargs):
  j_spec = getattr(j_features, name)(**kwargs).spec()
  t_spec = getattr(t_features, name)(**kwargs).spec()
  assert _spec_tuple(t_spec) == _spec_tuple(j_spec)
