"""Port parity for the simulator, environment pieces and the eval loop.

Adapters, goals, rewards, features and the deterministic part of a
simulator step agree element-wise with the JAX package on states carried
across from a JAX EnvState; the sampled laws (FOV scale, goal choice)
agree by KS; the slice end to end reaches the goal like the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import eval as t_eval_cli
from putting_dune_torch import eval_lib as t_eval_lib
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
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu import simulator as j_sim
from putting_dune_tpu import structures as j_struct
from putting_dune_tpu.env import action_adapters as j_adapters
from putting_dune_tpu.env import env as j_env
from putting_dune_tpu.env import features as j_features
from putting_dune_tpu.env import goals as j_goals

torch.set_num_threads(2)

J_LAT = j_lattice.make_lattice(50)
T_LAT = t_lattice.make_lattice(50)


def to_torch(tree):
  """Carries a JAX pytree (flax struct / dataclass / dict) across as the
  port's structures, leaf by leaf through numpy."""
  if tree is None:
    return None
  names = {
      j_struct.FieldOfView: t_struct.FieldOfView,
      j_struct.BeamControl: t_struct.BeamControl,
      j_struct.MaterialState: t_struct.MaterialState,
      j_struct.AtomWindow: t_struct.AtomWindow,
      j_struct.ImagingParams: t_struct.ImagingParams,
      j_struct.MicroscopeObservation: t_struct.MicroscopeObservation,
      j_struct.SimulatorState: t_struct.SimulatorState,
      j_goals.GoalState: t_goals.GoalState,
  }
  if type(tree) in names:
    cls = names[type(tree)]
    kwargs = {f.name: to_torch(getattr(tree, f.name))
              for f in dataclasses.fields(cls) if hasattr(tree, f.name)}
    return cls(**kwargs)
  if isinstance(tree, dict):
    return {k: to_torch(v) for k, v in tree.items()}
  t = torch.from_numpy(np.array(tree))
  # Site indices are int64 in the port.
  return t.long() if t.dtype == torch.int32 and t.dim() == 1 else t


def _jax_env_state(batch=16, seed=0, features=None):
  env = j_env.PuttingDuneEnv(
      lattice=J_LAT, rate_fn=j_rates.simple_canonical_rates,
      features=features or j_features.SingleSiliconPristineGrapheneFeatures(),
      batch_size=batch)
  state, ts = env.reset(jax.random.PRNGKey(seed))
  return env, state, ts


def _close(a, b, atol):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize('adapter', ['relative', 'material', 'direct',
                                     'delta'])
def test_adapters_match_jax(adapter):
  _, state, _ = _jax_env_state()
  fov = state.sim.fov
  si = j_lattice.site_position(J_LAT, state.sim.material.si_index,
                               state.sim.material.offset,
                               state.sim.material.theta)
  j_ctx = j_adapters.AdapterContext(fov.material_to_microscope(si), fov)
  t_fov = to_torch(fov)
  t_ctx = t_adapters.AdapterContext(
      torch.from_numpy(np.array(j_ctx.si_position_microscope)), t_fov)
  rng = np.random.default_rng(1)
  if adapter == 'relative':
    args = dict(max_distance_angstroms=1.42)
    j_ad = j_adapters.RelativeToSiliconActionAdapter(**args)
    t_ad = t_adapters.RelativeToSiliconActionAdapter(**args)
    action = rng.uniform(-1.3, 1.3, (16, 2)).astype(np.float32)
  elif adapter == 'material':
    args = dict(min_dwell_seconds=1.0, max_dwell_seconds=5.0,
                max_distance_angstroms=2.84)
    j_ad = j_adapters.RelativeToSiliconMaterialFrameActionAdapter(**args)
    t_ad = t_adapters.RelativeToSiliconMaterialFrameActionAdapter(**args)
    action = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    action[:, 2] = rng.uniform(-0.2, 1.2, 16)
  elif adapter == 'direct':
    j_ad = j_adapters.DirectActionAdapter(dwell_seconds=2.5)
    t_ad = t_adapters.DirectActionAdapter(dwell_seconds=2.5)
    action = rng.uniform(-0.3, 1.3, (16, 2)).astype(np.float32)
  else:
    j_ad = j_adapters.DeltaPositionActionAdapter()
    t_ad = t_adapters.DeltaPositionActionAdapter()
    action = rng.uniform(-0.15, 0.15, (16, 2)).astype(np.float32)
  # The delta adapter's beam state; the others carry None.
  beam = (rng.uniform(0, 1, (16, 2)).astype(np.float32)
          if adapter == 'delta' else None)
  assert dataclasses.astuple(j_ad.spec()) == dataclasses.astuple(t_ad.spec())
  j_state, jc = j_ad.to_controls(
      None if beam is None else jnp.asarray(beam), j_ctx, jnp.asarray(action))
  t_state, tc = t_ad.to_controls(
      None if beam is None else torch.from_numpy(beam), t_ctx,
      torch.from_numpy(action))
  _close(tc.position, jc.position, 1e-6)
  _close(tc.dwell_seconds, jc.dwell_seconds, 1e-6)
  if beam is None:
    assert t_state is None and j_state is None
  else:
    _close(t_state, j_state, 1e-6)


def test_delta_adapter_state_starts_uniform_and_survives_auto_reset():
  adapter = t_adapters.DeltaPositionActionAdapter()
  gen = torch.Generator().manual_seed(0)
  beam = adapter.init_state(gen, 20_000)
  assert beam.shape == (20_000, 2) and beam.dtype == torch.float32
  assert float(beam.min()) >= 0.0 and float(beam.max()) < 1.0
  assert abs(float(beam.mean()) - 0.5) < 0.01
  assert abs(float(beam.var()) - 1 / 12) < 0.002
  # In the env: the beam persists across steps, and a finished env's is
  # drawn anew with its fresh episode.
  env = t_env.PuttingDuneEnv(
      lattice=T_LAT, rate_fn=t_rates.simple_canonical_rates, adapter=adapter,
      batch_size=8, config=t_env.EnvConfig(step_limit=2, reset_chunk=4),
      device='cpu')
  state, _ = env.reset(gen)
  before = state.adapter_state.clone()
  step = torch.full((8, 2), 0.05)
  state, _ = env.step(state, step, gen)
  _close(state.adapter_state, torch.clamp(before + step, 0.0, 1.0), 1e-7)
  state, _ = env.step(state, step, gen)  # the step limit ends every episode
  state, ts = env.step(state, step, gen)
  assert bool(ts.first().all())
  assert not torch.allclose(state.adapter_state,
                            torch.clamp(before + 3 * step, 0.0, 1.0))


def test_features_match_jax():
  _, state, _ = _jax_env_state(seed=2)
  obs = j_sim._observe(J_LAT, state.sim, jnp.zeros(16), j_sim.SimulatorConfig(),
                       None, return_window=False, return_image=False)
  t_obs = to_torch(obs)
  t_goal = to_torch(state.goal)
  for j_f, t_f in [
      (j_features.SingleSiliconPristineGrapheneFeatures(),
       t_features.SingleSiliconPristineGrapheneFeatures()),
      (j_features.SingleSiliconMaterialFrameFeatures(),
       t_features.SingleSiliconMaterialFrameFeatures())]:
    _close(t_f(t_obs, t_goal), j_f(obs, state.goal), 2e-5)
  image = np.random.default_rng(3).uniform(0, 1, (16, 512, 512)).astype(
      np.float32)
  j_img = j_features.ImageFeatures()(obs.replace(image=jnp.asarray(image)),
                                     state.goal)
  t_img = t_features.ImageFeatures()(
      dataclasses.replace(t_obs, image=torch.from_numpy(image)), t_goal)
  assert t_img['image'].shape == (16, 128, 128, 1)
  np.testing.assert_array_equal(t_img['image'].numpy(),
                                np.asarray(j_img['image']))
  _close(t_img['goal_delta_angstroms'], j_img['goal_delta_angstroms'], 2e-5)


def test_reward_and_terminal_match_jax():
  _, state, _ = _jax_env_state(seed=3)
  rng = np.random.default_rng(4)
  goal_pos = np.asarray(state.goal.position_material)
  si = goal_pos + rng.normal(size=goal_pos.shape).astype(np.float32) * 0.8
  elapsed = rng.uniform(3, 10, 16).astype(np.float32)
  j_goal, j_ret = j_goals.reward_and_terminal(state.goal, si, elapsed)
  t_goal, t_ret = t_goals.reward_and_terminal(
      to_torch(state.goal), torch.from_numpy(si), torch.from_numpy(elapsed))
  np.testing.assert_array_equal(t_ret.is_terminal.numpy(),
                                np.asarray(j_ret.is_terminal))
  assert 0 < int(t_ret.is_terminal.sum()) < 16
  _close(t_ret.reward, j_ret.reward, 1e-6)
  np.testing.assert_array_equal(t_goal.consecutive_goal_steps.numpy(),
                                np.asarray(j_goal.consecutive_goal_steps))


def test_simulator_step_without_dwell_matches_jax():
  # dwell 0 runs no KMC event, so the step is deterministic: beam frame
  # conversion, clock, safe-area recentering and the observation.
  env, state, _ = _jax_env_state(batch=32, seed=5)
  rng = np.random.default_rng(5)
  # Random-walk the silicon so some envs leave the safe area.
  nbr = np.asarray(J_LAT.neighbors)
  si = np.asarray(state.sim.material.si_index)
  for _ in range(40):
    si = nbr[si, rng.integers(0, 3, si.shape)]
  sim_state = state.sim.replace(
      material=state.sim.material.replace(si_index=jnp.asarray(si)))
  position = rng.uniform(0, 1, (32, 2)).astype(np.float32)
  control = j_struct.BeamControl(jnp.asarray(position), jnp.zeros(32))
  j_state, j_obs, _ = j_sim.step(
      sim_state, jax.random.PRNGKey(0), control, J_LAT,
      j_rates.simple_canonical_rates, return_window=True)
  t_state, t_obs, result = t_sim.step(
      to_torch(sim_state), torch.Generator().manual_seed(0),
      t_struct.BeamControl(torch.from_numpy(position), torch.zeros(32)),
      T_LAT, t_rates.simple_canonical_rates, return_window=True)
  assert int(result.num_transitions.sum()) == 0
  _close(t_obs.elapsed_seconds, j_obs.elapsed_seconds, 0)
  assert 0 < float((t_obs.elapsed_seconds > 2.0).float().mean()) < 1
  _close(t_state.fov.lower_left, j_state.fov.lower_left, 1e-5)
  _close(t_state.fov.upper_right, j_state.fov.upper_right, 1e-5)
  _close(t_obs.si_position_microscope, j_obs.si_position_microscope, 1e-5)
  _close(t_obs.neighbor_positions_microscope,
         j_obs.neighbor_positions_microscope, 1e-5)
  np.testing.assert_array_equal(t_obs.silicon_in_view.numpy(),
                                np.asarray(j_obs.silicon_in_view))
  np.testing.assert_array_equal(t_obs.window.mask.numpy(),
                                np.asarray(j_obs.window.mask))


def test_reset_laws_match_jax():
  n = 2000
  j_state, j_obs = j_sim.reset(jax.random.PRNGKey(0), J_LAT, batch_size=n)
  gen = torch.Generator().manual_seed(0)
  t_state, t_obs = t_sim.reset(gen, T_LAT, batch_size=n)
  for j_x, t_x in [
      (j_state.fov.width, t_state.fov.width),
      (j_state.material.theta, t_state.material.theta),
      (j_state.material.offset[:, 0], t_state.material.offset[:, 0])]:
    assert scipy.stats.ks_2samp(np.asarray(j_x), t_x.numpy()).pvalue > 1e-3
  assert float(t_state.fov.width.min()) >= 15.0
  assert float(t_state.fov.width.max()) <= 30.0
  _close(t_obs.si_position_microscope, np.full((n, 2), 0.5), 1e-5)
  np.testing.assert_array_equal(t_obs.elapsed_seconds.numpy(), 2.0)
  # Goal choice: distance from the silicon, and whether the goal is in
  # view, by KS / proportions against the JAX sampler.
  j_goal = j_goals.sample_goal(jax.random.PRNGKey(1), J_LAT,
                               j_state.material, j_state.fov)
  t_goal = t_goals.sample_goal(gen, T_LAT, t_state.material, t_state.fov)
  si_j = j_lattice.site_position(J_LAT, j_state.material.si_index,
                                 j_state.material.offset,
                                 j_state.material.theta)
  d_j = np.linalg.norm(np.asarray(j_goal.position_material - si_j), axis=-1)
  si_t = t_lattice.site_position(T_LAT, t_state.material.si_index,
                                 t_state.material.offset,
                                 t_state.material.theta)
  d_t = torch.linalg.vector_norm(t_goal.position_material - si_t,
                                 dim=-1).numpy()
  assert scipy.stats.ks_2samp(d_j, d_t).pvalue > 1e-3
  assert d_t.min() > 0.1
  inside = t_state.fov.material_to_microscope(t_goal.position_material)
  assert bool(((inside >= 0) & (inside <= 1)).all())


def test_drift_raises():
  # A drift config is accepted: reset starts every row at zero drift, and
  # one step moves each row's drift by at most d per axis.
  config = t_sim.SimulatorConfig(drift_per_frame_angstroms=0.5)
  gen = torch.Generator().manual_seed(0)
  state, _ = t_sim.reset(gen, T_LAT, config=config, batch_size=64)
  assert float(state.drift.abs().max()) == 0.0
  control = t_struct.BeamControl(torch.full((64, 2), 0.5), torch.zeros(64))
  state, _, _ = t_sim.step(state, gen, control, T_LAT,
                           t_rates.simple_canonical_rates, config=config)
  assert 0.0 < float(state.drift.abs().max()) <= 0.5


def test_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('this check needs a machine without CUDA')
  with pytest.raises(RuntimeError, match='CUDA'):
    t_env.PuttingDuneEnv()
  exp = t_registry.create_eval_experiment('greedy_simple_rates')
  with pytest.raises(RuntimeError, match='CUDA'):
    t_run_helpers.create_batched_env(exp.get_adapters_and_goal,
                                     exp.get_simulator_config)
  with pytest.raises(RuntimeError, match='CUDA'):
    t_eval_cli.main(t_eval_cli.Args(experiment_name='greedy_simple_rates'))


@pytest.mark.parametrize('reset_chunk', [1, 64])
def test_env_auto_reset_paths(reset_chunk):
  # reset_chunk=1 makes simultaneous finishes take the full-batch path,
  # 64 the sub-batch path; both must give fresh FIRST steps.
  exp = t_registry.create_eval_experiment('greedy_simple_rates')
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=24,
      step_limit=4, device='cpu')
  env.config = dataclasses.replace(env.config, reset_chunk=reset_chunk)
  policy = exp.get_policy(exp.get_adapters_and_goal(), 'cpu')
  gen = torch.Generator().manual_seed(0)
  state, ts = env.reset(gen)
  assert bool((ts.step_type == t_env.FIRST).all())
  gamma = 0.9967
  seen_reset = 0
  for _ in range(10):
    prev = ts
    state, ts = env.step(state, policy(gen, ts.observation), gen)
    restarted = prev.step_type == t_env.LAST
    seen_reset += int(restarted.sum())
    assert bool((ts.step_type[restarted] == t_env.FIRST).all())
    assert bool((ts.reward[restarted] == 0).all())
    _close(ts.discount[restarted], gamma ** 2.0 * np.ones(
        int(restarted.sum())), 1e-6)
    assert bool((state.step_count[restarted] == 0).all())
    mid = ~restarted
    terminal = mid & (ts.step_type == t_env.LAST) & (ts.discount == 0)
    assert bool((ts.reward[terminal] > 0).all())
  assert seen_reset >= 24


def test_greedy_simple_rates_tiny_eval_reaches_goal():
  report = t_eval_cli.main(t_eval_cli.Args(
      experiment_name='greedy_simple_rates', eval_suite='tiny_eval',
      device='cpu'))
  agg = report['aggregate']
  assert agg['average_num_times_reached_goal'] == 1.0
  assert 7.0 <= agg['average_num_actions_taken'] <= 12.0


def test_random_agent_matches_jax_success_rate():
  report = t_eval_cli.main(t_eval_cli.Args(
      experiment_name='relative_random_simple', eval_suite='small_eval',
      device='cpu'))
  # The JAX package reaches 0.09 on small_eval; n=100 binomial band.
  rate = report['aggregate']['average_num_times_reached_goal']
  assert 0.01 <= rate <= 0.2


def test_ppo_images_128_render_reaches_goal():
  report = t_eval_cli.main(t_eval_cli.Args(
      experiment_name='ppo_simple_images_tf', eval_suite='tiny_eval',
      image_size=128, device='cpu'))
  assert report['aggregate']['average_num_times_reached_goal'] >= 0.9


def test_ppo_images_512_render_reaches_goal():
  exp = t_registry.create_eval_experiment('ppo_simple_images_tf')
  seeds = (0, 1, 2)
  env = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds), device='cpu')
  assert env.config.sim.image_size == 512
  policy = exp.get_policy(exp.get_adapters_and_goal(), 'cpu')
  results = t_eval_lib.evaluate_batched(env, policy, seeds)
  assert all(r.reached_goal for r in results)
