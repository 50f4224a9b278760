"""The port's instrument drift against the JAX package, on the CPU.

Simulator, envs and eval loop. Inputs are made with numpy from a seed and
go through the JAX function and its counterpart in putting_dune_torch in
one process. With dwell 0 no KMC event fires, so a step with an injected
drift (and d = 0, no increment) is deterministic and is held element-wise
(tolerance at each test); the beam is read where each package hands it to
its KMC, and frames are rendered clean (the noise chain samples). The
increments and whole evals sample (threefry against Philox), so they are
held in law: KS and z-tests. A seeded drift-free rollout is held to the
tensors the port gave before drift was ported
(tests/data/torch_drift_free_rollout.npz): the random stream is unchanged.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import kmc as t_kmc
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch import simulator as t_sim
from putting_dune_torch import structures as t_struct
from putting_dune_torch.env import action_adapters as t_adapters
from putting_dune_torch.env import env as t_env
from putting_dune_torch.env import features as t_features
from putting_dune_torch.env import goals as t_goals
from putting_dune_torch.env import multi_dopant as t_md
from putting_dune_torch.imaging import params as t_params
from putting_dune_torch.imaging import render as t_render
from putting_dune_tpu import eval as j_eval_cli
from putting_dune_tpu import eval_lib as j_eval_lib
from putting_dune_tpu import kmc as j_kmc
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu import run_helpers as j_run_helpers
from putting_dune_tpu import simulator as j_sim
from putting_dune_tpu import structures as j_struct
from putting_dune_tpu.env import action_adapters as j_adapters
from putting_dune_tpu.env import env as j_env
from putting_dune_tpu.env import features as j_features
from putting_dune_tpu.env import multi_dopant as j_md
from putting_dune_tpu.experiments import registry as j_registry
from putting_dune_tpu.imaging import render as j_render

torch.set_num_threads(2)

GOLDEN = (pathlib.Path(__file__).resolve().parent / 'data'
          / 'torch_drift_free_rollout.npz')
J_LAT = j_lattice.make_lattice(50)
T_LAT = t_lattice.make_lattice(50)
J_LAT_20 = j_lattice.make_lattice(20)
T_LAT_20 = t_lattice.make_lattice(20)

SINGLE_DRIFT_ENTRIES = (
    'planner_simple_drift', 'ppo_simple_drift',
    'planner_simple_drift_variable_time', 'planner_simple_drift_frame_dwell',
    'vision_planner_drift', 'vision_planner_drift_corrected')
MULTI_DRIFT_ENTRIES = ('multi_dopant_2_vision_planner_drift',
                       'multi_dopant_2_vision_planner_drift_corrected')


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(got, want, atol):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                             rtol=0)


def to_torch(tree):
  """Carries a JAX structure across as the port's, leaf by leaf."""
  if tree is None:
    return None
  names = {
      j_struct.FieldOfView: t_struct.FieldOfView,
      j_struct.MaterialState: t_struct.MaterialState,
      j_struct.ImagingParams: t_struct.ImagingParams,
      j_struct.SimulatorState: t_struct.SimulatorState,
      j_env.EnvState: t_env.EnvState,
      j_md.MultiDopantState: t_md.MultiDopantState,
      j_env.goals_lib.GoalState: t_goals.GoalState,
  }
  if type(tree) in names:
    cls = names[type(tree)]
    # Site indices are int64 in the port.
    return cls(**{f.name: (to_torch(getattr(tree, f.name)).long()
                           if f.name in ('si_index', 'si_indices')
                           else to_torch(getattr(tree, f.name)))
                  for f in dataclasses.fields(cls)})
  return _t(tree)


def _capture(monkeypatch, module, name, store, key, arg):
  """Wraps module.name to record its positional argument `arg`."""
  original = getattr(module, name)

  def wrapper(*args, **kwargs):
    store[key] = args[arg]
    return original(*args, **kwargs)

  monkeypatch.setattr(module, name, wrapper)


def _clean_render(monkeypatch):
  """Both packages' frames rendered clean (the noise chain samples)."""

  def j_clean(key, window, fov, imaging, *, image_size):
    del key
    return j_render.render_clean_image(
        window, fov, imaging.intensity_exponent, image_size=image_size,
        blur_amount=imaging.blur_amount)

  def t_clean(gen, window, fov, imaging, *, image_size):
    del gen
    return t_render.render_clean_image(
        window, fov, imaging.intensity_exponent, image_size=image_size,
        blur_amount=imaging.blur_amount)

  monkeypatch.setattr(j_render, 'render_stem_image', j_clean)
  monkeypatch.setattr(t_render, 'render_stem_image', t_clean)


def _random_walk(rng, lattice, si, steps):
  nbr = np.asarray(lattice.neighbors)
  for _ in range(steps):
    si = nbr[si, rng.integers(0, 3, si.shape)]
  return si


# --- simulator ----------------------------------------------------------------


def test_observe_with_drift_matches_jax():
  batch = 16
  j_state, _ = j_sim.reset(jax.random.PRNGKey(3), J_LAT, batch_size=batch)
  drift = np.random.default_rng(3).uniform(-3, 3, (batch, 2))
  j_state = j_state.replace(drift=jnp.asarray(drift, jnp.float32))
  t_state = to_torch(j_state)
  elapsed = np.full((batch,), 7.0, np.float32)
  j_obs = j_sim._observe(J_LAT, j_state, jnp.asarray(elapsed),
                         j_sim.SimulatorConfig(), None, return_window=True,
                         return_image=False, drift=j_state.drift)
  t_obs = t_sim._observe(T_LAT, t_state, _t(elapsed), t_sim.SimulatorConfig(),
                         None, return_window=True, return_image=False)
  # Float32 geometry: 1e-5 in microscope units (~3e-4 A at 30 A).
  _close(t_obs.si_position_microscope, j_obs.si_position_microscope, 1e-5)
  _close(t_obs.neighbor_positions_microscope,
         j_obs.neighbor_positions_microscope, 1e-5)
  np.testing.assert_array_equal(t_obs.silicon_in_view.numpy(),
                                np.asarray(j_obs.silicon_in_view))
  np.testing.assert_array_equal(t_obs.window.mask.numpy(),
                                np.asarray(j_obs.window.mask))
  _close(t_obs.window.positions, j_obs.window.positions, 1e-5)
  # The observation reports the believed FOV, and the silicon it shows
  # sits at the true position plus the drift.
  assert torch.equal(t_obs.fov.lower_left, t_state.fov.lower_left)
  si = t_lattice.site_position(T_LAT, t_state.material.si_index,
                               t_state.material.offset, t_state.material.theta)
  _close(t_obs.fov.microscope_to_material(t_obs.si_position_microscope),
         si + t_state.drift, 1e-4)


def test_step_with_injected_drift_matches_jax(monkeypatch):
  # d = 0 and dwell 0: no increment and no KMC event, so the step is
  # deterministic: the beam at -drift, the safe-area check and the
  # recentering on the observed silicon, the clock and the observation.
  batch = 32
  j_state, _ = j_sim.reset(jax.random.PRNGKey(5), J_LAT, batch_size=batch)
  rng = np.random.default_rng(5)
  si = _random_walk(rng, J_LAT, np.asarray(j_state.material.si_index), 20)
  drift = rng.uniform(-4, 4, (batch, 2)).astype(np.float32)
  j_state = j_state.replace(
      material=j_state.material.replace(si_index=jnp.asarray(si)),
      drift=jnp.asarray(drift))
  position = rng.uniform(0, 1, (batch, 2)).astype(np.float32)
  beams = {}
  _capture(monkeypatch, j_kmc, 'apply_control', beams, 'jax', 5)
  _capture(monkeypatch, t_kmc, 'apply_control', beams, 'torch', 5)
  with jax.disable_jit():
    j_new, j_obs, _ = j_sim.step(
        j_state, jax.random.PRNGKey(0),
        j_struct.BeamControl(jnp.asarray(position), jnp.zeros(batch)), J_LAT,
        j_rates.simple_canonical_rates, return_window=True)
  t_state = to_torch(j_state)
  t_new, t_obs, result = t_sim.step(
      t_state, torch.Generator().manual_seed(0),
      t_struct.BeamControl(_t(position), torch.zeros(batch)), T_LAT,
      t_rates.simple_canonical_rates, return_window=True)
  assert int(result.num_transitions.sum()) == 0
  _close(beams['torch'], beams['jax'], 1e-4)
  _close(beams['torch'],
         t_state.fov.microscope_to_material(_t(position)) - _t(drift), 1e-5)
  assert torch.equal(t_new.drift, _t(drift))
  _close(t_obs.elapsed_seconds, j_obs.elapsed_seconds, 0)
  recentered = (t_obs.elapsed_seconds > 2.0).numpy()
  assert 0 < recentered.mean() < 1
  _close(t_new.fov.lower_left, j_new.fov.lower_left, 1e-4)
  _close(t_new.fov.upper_right, j_new.fov.upper_right, 1e-4)
  # Recentred rows centre on the observed silicon, true + drift.
  si_true = t_lattice.site_position(T_LAT, t_new.material.si_index,
                                    t_new.material.offset,
                                    t_new.material.theta)
  _close(t_new.fov.offset[recentered], (si_true + _t(drift))[recentered],
         1e-4)
  _close(t_obs.si_position_microscope, j_obs.si_position_microscope, 1e-5)
  np.testing.assert_array_equal(t_obs.window.mask.numpy(),
                                np.asarray(j_obs.window.mask))


def test_drift_increment_law_matches_jax():
  n = 2000
  d = 0.5
  t_config = t_sim.SimulatorConfig(drift_per_frame_angstroms=d)
  gen = torch.Generator().manual_seed(11)
  t_state, _ = t_sim.reset(gen, T_LAT, config=t_config, batch_size=n)
  # The increment is the step's first draw, ahead of the KMC.
  twin = torch.Generator()
  twin.set_state(gen.get_state())
  control = t_struct.BeamControl(torch.full((n, 2), 0.5), torch.full((n,), 1.5))
  t_new, _, _ = t_sim.step(t_state, gen, control, T_LAT,
                           t_rates.simple_canonical_rates, config=t_config)
  assert torch.equal(t_new.drift, torch.rand((n, 2), generator=twin) * 2 * d - d)
  j_config = j_sim.SimulatorConfig(drift_per_frame_angstroms=d)
  j_state, _ = j_sim.reset(jax.random.PRNGKey(11), J_LAT, config=j_config,
                           batch_size=n)
  j_new, _, _ = j_sim.step(
      j_state, jax.random.PRNGKey(12),
      j_struct.BeamControl(jnp.full((n, 2), 0.5), jnp.full((n,), 1.5)), J_LAT,
      j_rates.simple_canonical_rates, config=j_config)
  for axis in (0, 1):
    got = t_new.drift[:, axis].numpy()
    want = np.asarray(j_new.drift)[:, axis]
    assert scipy.stats.kstest(got, 'uniform', args=(-d, 2 * d)).pvalue > 1e-3
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3


def test_image_features_include_fov_match_jax():
  batch = 6
  j_state, j_obs = j_sim.reset(jax.random.PRNGKey(2), J_LAT, batch_size=batch)
  image = np.random.default_rng(2).uniform(size=(batch, 64, 64)).astype(
      np.float32)
  j_obs = j_obs.replace(image=jnp.asarray(image))
  goal = j_env.goals_lib.sample_goal(jax.random.PRNGKey(3), J_LAT,
                                     j_state.material, j_state.fov)
  for include_fov in (False, True):
    j_feat = j_features.ImageFeatures(image_size=32, include_fov=include_fov)
    t_feat = t_features.ImageFeatures(image_size=32, include_fov=include_fov)
    want = j_feat(j_obs, goal)
    t_obs = t_struct.MicroscopeObservation(
        fov=to_torch(j_obs.fov),
        si_position_microscope=_t(j_obs.si_position_microscope),
        neighbor_positions_microscope=_t(j_obs.neighbor_positions_microscope),
        elapsed_seconds=_t(j_obs.elapsed_seconds),
        silicon_in_view=_t(j_obs.silicon_in_view), image=_t(image))
    got = t_feat(t_obs, to_torch(goal))
    assert sorted(got) == sorted(want)
    assert sorted(t_feat.spec()) == sorted(j_feat.spec())
    for key in want:
      assert got[key].dtype == torch.float32
      assert t_feat.spec()[key].shape == j_feat.spec()[key].shape
      # Bilinear resize and float32 geometry: 1e-5.
      _close(got[key], want[key], 1e-5)
    assert ('fov_lower_left' in got) == include_fov


def _single_envs(batch, **sim):
  kwargs = dict(
      adapter=dict(min_dwell_seconds=0.0, max_dwell_seconds=0.0,
                   max_distance_angstroms=2 * 1.42),
      features=dict(image_size=32, include_fov=True))
  j_envir = j_env.PuttingDuneEnv(
      lattice=J_LAT, rate_fn=j_rates.simple_canonical_rates,
      adapter=j_adapters.RelativeToSiliconActionAdapter(**kwargs['adapter']),
      features=j_features.ImageFeatures(**kwargs['features']),
      config=j_env.EnvConfig(sim=j_sim.SimulatorConfig(image_size=32, **sim)),
      batch_size=batch)
  t_envir = t_env.PuttingDuneEnv(
      lattice=T_LAT, rate_fn=t_rates.simple_canonical_rates,
      adapter=t_adapters.RelativeToSiliconActionAdapter(**kwargs['adapter']),
      features=t_features.ImageFeatures(**kwargs['features']),
      config=t_env.EnvConfig(sim=t_sim.SimulatorConfig(image_size=32, **sim)),
      batch_size=batch, device='cpu')
  return j_envir, t_envir


def test_env_step_with_injected_drift_matches_jax(monkeypatch):
  # The adapter aims at the silicon observed in the last frame, the frame
  # is rendered through the believed FOV shifted by -drift (clean here),
  # the features report the believed FOV; d = 0 and dwell 0 keep the step
  # deterministic.
  batch = 12
  j_envir, t_envir = _single_envs(batch)
  j_state, _ = j_envir.reset(jax.random.PRNGKey(4))
  rng = np.random.default_rng(4)
  drift = rng.uniform(-3, 3, (batch, 2)).astype(np.float32)
  si = _random_walk(rng, J_LAT, np.asarray(j_state.sim.material.si_index), 8)
  j_state = j_state.replace(sim=j_state.sim.replace(
      drift=jnp.asarray(drift),
      material=j_state.sim.material.replace(si_index=jnp.asarray(si))))
  t_state = to_torch(j_state)
  action = rng.uniform(-1, 1, (batch, 2)).astype(np.float32)
  _clean_render(monkeypatch)
  controls = {}
  _capture(monkeypatch, j_sim, 'step', controls, 'jax', 2)
  _capture(monkeypatch, t_sim, 'step', controls, 'torch', 2)
  with jax.disable_jit():
    j_new, j_ts = j_envir.step(j_state, jnp.asarray(action),
                               jax.random.PRNGKey(5))
  t_new, t_ts = t_envir.step(t_state, _t(action),
                             torch.Generator().manual_seed(5))
  _close(controls['torch'].position, controls['jax'].position, 1e-5)
  si_true = t_lattice.site_position(
      T_LAT, t_state.sim.material.si_index, t_state.sim.material.offset,
      t_state.sim.material.theta)
  aimed = t_state.sim.fov.material_to_microscope(si_true + _t(drift))
  cell = 2 * 1.42 / t_state.sim.fov.width[:, None]
  _close(controls['torch'].position,
         torch.clamp(aimed + _t(action) * cell, 0.0, 1.0), 1e-5)
  assert torch.equal(t_new.sim.drift, _t(drift))
  _close(t_new.sim.fov.lower_left, j_new.sim.fov.lower_left, 1e-4)
  obs, j_obs = t_ts.observation, j_ts.observation
  assert sorted(obs) == sorted(j_obs)
  _close(obs['fov_lower_left'], j_obs['fov_lower_left'], 1e-4)
  _close(obs['fov_upper_right'], j_obs['fov_upper_right'], 1e-4)
  # The stale goal: goal - (true + drift), in the true goal's frame.
  _close(obs['goal_delta_angstroms'], j_obs['goal_delta_angstroms'], 1e-4)
  # The clean frame through the shifted FOV: float32 splat, 1e-4 of a
  # max-normalised frame.
  _close(obs['image'], j_obs['image'], 1e-4)
  _close(t_ts.reward, j_ts.reward, 1e-6)


# --- multi-dopant env ---------------------------------------------------------


def _md_envs(batch, **kwargs):
  common = dict(batch_size=batch, num_dopants=2, dwell_seconds=0.0, **kwargs)
  return (j_md.MultiDopantEnv(lattice=J_LAT, rate_fn=j_rates.simple_canonical_rates,
                              **common),
          t_md.MultiDopantEnv(lattice=T_LAT, rate_fn=t_rates.simple_canonical_rates,
                              device='cpu', **common))


def _md_drifted_state(j_envir, seed):
  j_state, _ = j_envir.reset(jax.random.PRNGKey(seed))
  rng = np.random.default_rng(seed)
  batch = j_envir.batch_size
  drift = rng.uniform(-2, 2, (batch, 2)).astype(np.float32)
  latched = np.zeros((batch, 2), bool)
  latched[::3, 0] = True
  return j_state.replace(drift=jnp.asarray(drift),
                         latched=jnp.asarray(latched)), drift, rng


@pytest.mark.parametrize('observation_mode', ['vector', 'vector_neighbors'])
def test_multi_dopant_step_with_injected_drift_matches_jax(monkeypatch,
                                                           observation_mode):
  batch = 9
  j_envir, t_envir = _md_envs(batch, observation_mode=observation_mode,
                              anchor_order='position')
  j_state, drift, rng = _md_drifted_state(j_envir, 6)
  t_state = to_torch(j_state)
  # Observed dopants at true + drift, the goals gone stale by it.
  _close(t_envir._observation(t_state), j_envir._observation(j_state), 1e-4)
  action = rng.uniform(-1, 1, (batch, 2)).astype(np.float32)
  beams = {}
  _capture(monkeypatch, j_kmc, 'apply_control_multi', beams, 'jax', 5)
  _capture(monkeypatch, t_kmc, 'apply_control_multi', beams, 'torch', 5)
  with jax.disable_jit():
    j_new, j_ts = j_envir.step(j_state, jnp.asarray(action),
                               jax.random.PRNGKey(7))
  t_new, t_ts = t_envir.step(t_state, _t(action),
                             torch.Generator().manual_seed(7))
  _close(beams['torch'], beams['jax'], 1e-4)
  # The beam: the observed anchor + the action, landing at -drift.
  si_obs = t_envir._si_positions(t_state) + _t(drift)[:, None, :]
  pick = t_envir._anchor_index(t_state, si_obs)
  anchor = si_obs[torch.arange(batch), pick]
  _close(beams['torch'], anchor + _t(action) * 2 * 1.42 - _t(drift), 1e-5)
  assert torch.equal(t_new.drift, _t(drift))
  np.testing.assert_array_equal(t_new.si_indices.numpy(),
                                np.asarray(j_new.si_indices))
  _close(t_ts.observation, j_ts.observation, 1e-4)


def test_multi_dopant_image_observation_with_drift_matches_jax(monkeypatch):
  batch = 6
  j_envir, t_envir = _md_envs(batch, observation_mode='image',
                              anchor_order='position', image_size=32,
                              include_fov=True)
  j_state, _, _ = _md_drifted_state(j_envir, 8)
  t_state = to_torch(j_state)
  _clean_render(monkeypatch)
  want = j_envir._observation(j_state, jax.random.PRNGKey(0))
  got = t_envir._observation(t_state, torch.Generator())
  assert sorted(got) == sorted(want)
  # The believed FOV; the clean frame through it shifted by -drift.
  np.testing.assert_array_equal(got['fov_lower_left'].numpy(),
                                np.asarray(want['fov_lower_left']))
  _close(got['goal_delta_angstroms'], want['goal_delta_angstroms'], 1e-4)
  _close(got['image'], want['image'], 1e-4)
  shifted = t_render.render_clean_image(
      t_envir._atom_window(t_state), t_envir._fov(t_state),
      t_state.imaging.intensity_exponent, image_size=32,
      blur_amount=t_state.imaging.blur_amount)
  assert float((got['image'][..., 0] - shifted).abs().max()) > 0.1


def test_multi_dopant_drift_increment_law_matches_jax():
  n, d = 1000, 0.5
  t_envir = t_md.MultiDopantEnv(
      lattice=T_LAT_20, rate_fn=t_rates.simple_canonical_rates, batch_size=n,
      drift_per_frame_angstroms=d, device='cpu')
  gen = torch.Generator().manual_seed(13)
  t_state, _ = t_envir.reset(gen)
  twin = torch.Generator()
  twin.set_state(gen.get_state())
  t_new, _ = t_envir.step(t_state, torch.zeros((n, 2)), gen)
  assert torch.equal(t_new.drift, torch.rand((n, 2), generator=twin) * 2 * d - d)
  j_envir = j_md.MultiDopantEnv(
      lattice=J_LAT_20, rate_fn=j_rates.simple_canonical_rates, batch_size=n,
      drift_per_frame_angstroms=d)
  j_state, _ = j_envir.reset(jax.random.PRNGKey(13))
  j_new, _ = j_envir.step(j_state, jnp.zeros((n, 2)), jax.random.PRNGKey(14))
  for axis in (0, 1):
    got = t_new.drift[:, axis].numpy()
    assert scipy.stats.kstest(got, 'uniform', args=(-d, 2 * d)).pvalue > 1e-3
    assert scipy.stats.ks_2samp(
        got, np.asarray(j_new.drift)[:, axis]).pvalue > 1e-3


# --- the eval loop ------------------------------------------------------------


class _RecordingCorrector(t_eval_lib.StatefulPolicy):
  """A drift corrector on raw frames that records what the loop gives it."""

  def __init__(self):
    from putting_dune_torch.agents import drift_correction as t_dc

    self._inner = t_dc.DriftCorrectedPolicy(
        lambda gen, obs: torch.zeros((obs['image'].shape[0], 2)))
    self.firsts, self.drifts = [], []

  def init(self, example_obs):
    return self._inner.init(example_obs)

  def step(self, pstate, gen, obs, first):
    pstate, action = self._inner.step(pstate, gen, obs, first)
    self.firsts.append(first.clone())
    self.drifts.append(pstate['drift'].clone())
    return pstate, action


def test_evaluate_batched_carries_a_stateful_policy():
  batch = 4
  envir = t_env.PuttingDuneEnv(
      lattice=T_LAT_20, features=t_features.ImageFeatures(
          image_size=64, include_fov=True),
      config=t_env.EnvConfig(sim=t_sim.SimulatorConfig(
          grid_columns=20, image_size=64, drift_per_frame_angstroms=0.5),
          step_limit=5),
      batch_size=batch, device='cpu')
  # After the second step env 0 is flagged for a reset, so the third step
  # hands it a FIRST timestep while the others go on.
  stepped = []
  step = envir.step

  def flagging_step(state, action, gen):
    state, ts = step(state, action, gen)
    stepped.append(ts.first().clone())
    if len(stepped) == 2:
      state.needs_reset = state.needs_reset.clone()
      state.needs_reset[0] = True
    return state, ts

  envir.step = flagging_step
  policy = _RecordingCorrector()
  results = t_eval_lib.evaluate_batched(envir, policy, list(range(batch)))
  assert len(results) == batch
  assert all(r.num_actions_taken <= 5 for r in results)
  assert results[0].num_actions_taken == 3
  # `first` is the FIRST mask of the timestep the policy acts on.
  assert bool(policy.firsts[0].all())
  for k in range(1, len(policy.firsts)):
    assert torch.equal(policy.firsts[k], stepped[k - 1])
  assert bool(policy.firsts[3][0]) and not bool(policy.firsts[3][1:].any())
  # FIRST rows re-initialise their carry; the others accumulate drift.
  for first, drift in zip(policy.firsts, policy.drifts):
    assert float(drift[first].abs().sum()) == 0.0
  assert float(policy.drifts[2][1:].abs().max()) > 0.0


def _z(p1, p2, n1, n2):
  p = (p1 * n1 + p2 * n2) / (n1 + n2)
  se = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
  return (p1 - p2) / se if se > 0 else 0.0


def test_planner_simple_drift_matches_jax_in_distribution():
  # Both packages on 200 seeds on the CPU (their streams differ): the
  # success rates and the actions to goal within 4 standard errors.
  seeds = tuple(range(200))
  exp = j_registry.create_eval_experiment('planner_simple_drift')
  agent = exp.get_agent(np.random.default_rng(0), exp.get_adapters_and_goal())
  j_envir = j_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds))
  want = j_eval_lib.evaluate_batched(
      j_envir, j_eval_cli._policy_for_agent(agent, j_envir), seeds)
  t_exp = t_registry.create_eval_experiment('planner_simple_drift')
  t_envir = t_run_helpers.create_batched_env(
      t_exp.get_adapters_and_goal, t_exp.get_simulator_config,
      batch_size=len(seeds), device='cpu')
  assert t_envir.config.sim.drift_per_frame_angstroms == 0.5
  got = t_eval_lib.evaluate_batched(
      t_envir, t_exp.get_policy(t_exp.get_adapters_and_goal(), 'cpu').policy(),
      seeds)
  j_ok = np.array([r.reached_goal for r in want])
  t_ok = np.array([r.reached_goal for r in got])
  assert 0.7 <= t_ok.mean() < 1.0
  assert abs(_z(t_ok.mean(), j_ok.mean(), len(seeds), len(seeds))) < 4.0
  j_act = np.array([r.num_actions_taken for r in want])[j_ok]
  t_act = np.array([r.num_actions_taken for r in got])[t_ok]
  se = np.hypot(j_act.std(ddof=1) / np.sqrt(len(j_act)),
                t_act.std(ddof=1) / np.sqrt(len(t_act)))
  assert abs(t_act.mean() - j_act.mean()) / se < 4.0


# --- registry -----------------------------------------------------------------


@pytest.mark.parametrize('name', SINGLE_DRIFT_ENTRIES)
def test_single_dopant_drift_entries_build_as_in_jax(name):
  assert name in t_registry.eval_experiment_names()
  t_exp = t_registry.create_eval_experiment(name)
  j_exp = j_registry.create_eval_experiment(name)
  t_spec, j_spec = t_exp.get_simulator_config(), j_exp.get_simulator_config()
  assert t_spec.drift_per_frame_angstroms == j_spec.drift_per_frame_angstroms
  assert t_spec.drift_per_frame_angstroms == 0.5
  assert t_spec.rate_fn.__name__ == j_spec.rate_fn.__name__
  assert t_spec.image_duration_seconds == j_spec.image_duration_seconds
  t_parts, j_parts = t_exp.get_adapters_and_goal(), j_exp.get_adapters_and_goal()
  for part in ('action_adapter', 'feature_constructor'):
    t_obj, j_obj = getattr(t_parts, part), getattr(j_parts, part)
    assert type(t_obj).__name__ == type(j_obj).__name__, (name, part)
    for field in dataclasses.fields(t_obj):
      assert getattr(t_obj, field.name) == getattr(j_obj, field.name), (
          name, part, field.name)
  # One step of the policy on a small batch (64^2 frames here).
  envir = t_run_helpers.create_batched_env(
      t_exp.get_adapters_and_goal, t_exp.get_simulator_config, batch_size=2,
      image_size=64, device='cpu')
  from putting_dune_torch import eval as t_eval_cli

  policy = t_eval_cli.policy_for_agent(t_exp.get_policy(t_parts, 'cpu'))
  gen = torch.Generator().manual_seed(0)
  state, ts = envir.reset(gen)
  pstate, policy_step = t_eval_lib.policy_stepper(policy, ts.observation)
  _, action = policy_step(pstate, gen, ts.observation, ts.first())
  assert bool(torch.isfinite(action).all())
  state, ts = envir.step(state, action, gen)
  assert float(state.sim.drift.abs().max()) > 0.0


@pytest.mark.parametrize('name', MULTI_DRIFT_ENTRIES)
def test_multi_dopant_drift_entries_build_as_in_jax(name):
  t_exp = t_registry.create_multi_dopant_experiment(name)
  t_envir = t_exp.make_env(2, device='cpu')
  j_envir = j_registry.create_multi_dopant_experiment(name).make_env(2)
  for field in ('drift_per_frame_angstroms', 'include_fov', 'image_size',
                'observation_mode', 'anchor_order', 'num_dopants'):
    assert getattr(t_envir, field) == getattr(j_envir, field), field
  from putting_dune_torch import eval as t_eval_cli

  policy = t_eval_cli.policy_for_agent(t_exp.get_agent('cpu'))
  assert isinstance(policy, t_eval_lib.StatefulPolicy) == name.endswith(
      '_corrected')
  gen = torch.Generator().manual_seed(0)
  state, ts = t_envir.reset(gen)
  pstate, policy_step = t_eval_lib.policy_stepper(policy, ts.observation)
  _, action = policy_step(pstate, gen, ts.observation, ts.first())
  assert action.shape == (2, 2) and bool(torch.isfinite(action).all())
  state, ts = t_envir.step(state, action, gen)
  assert float(state.drift.abs().max()) > 0.0
  assert sorted(ts.observation) == sorted(j_envir.observation_spec())


# --- the drift-free stream ----------------------------------------------------


def drift_free_rollout():
  """A seeded rollout of both envs with drift off, on the CPU: frames,
  goal deltas, rewards, sites and FOVs over auto-resets. Drift draws
  nothing when it is off, so these stay what they were before it was
  ported."""
  out = {}
  gen = torch.Generator().manual_seed(7)
  envir = t_env.PuttingDuneEnv(
      lattice=T_LAT_20, rate_fn=t_rates.simple_canonical_rates,
      features=t_features.ImageFeatures(image_size=32),
      config=t_env.EnvConfig(sim=t_sim.SimulatorConfig(
          grid_columns=20, image_size=32), step_limit=2, reset_chunk=2),
      batch_size=4, device='cpu')
  state, ts = envir.reset(gen)
  for i in range(4):
    action = torch.rand((4, 2), generator=gen) * 2 - 1
    state, ts = envir.step(state, action, gen)
    out[f'single_image_{i}'] = ts.observation['image'].numpy()
    out[f'single_goal_{i}'] = ts.observation['goal_delta_angstroms'].numpy()
    out[f'single_reward_{i}'] = ts.reward.numpy()
    out[f'single_si_{i}'] = state.sim.material.si_index.numpy()
    out[f'single_fov_{i}'] = state.sim.fov.lower_left.numpy()
  md = t_md.MultiDopantEnv(
      lattice=T_LAT_20, rate_fn=t_rates.simple_canonical_rates, batch_size=3,
      num_dopants=2, observation_mode='image', anchor_order='position',
      image_size=32, step_limit=2, device='cpu')
  state, ts = md.reset(gen)
  for i in range(4):
    action = torch.rand((3, 2), generator=gen) * 2 - 1
    state, ts = md.step(state, action, gen)
    out[f'multi_image_{i}'] = ts.observation['image'].numpy()
    out[f'multi_goal_{i}'] = ts.observation['goal_delta_angstroms'].numpy()
    out[f'multi_reward_{i}'] = ts.reward.numpy()
    out[f'multi_si_{i}'] = state.si_indices.numpy()
  return out


def test_drift_free_rollout_is_unchanged():
  want = np.load(GOLDEN)
  got = drift_free_rollout()
  assert sorted(got) == sorted(want.files)
  for key, value in got.items():
    np.testing.assert_array_equal(value, want[key], err_msg=key)
