"""The port's single-dopant registry against the JAX package's, on the CPU.

Every one of the JAX package's single-dopant eval names and train names is
in the port, composed the same way: the adapter's dwells and distance, the
features, the simulator's rate law and image duration, and the agent
(planner rate law and dwell, greedy argmax, checkpoint outputs, the
learned rate model).
`planner_learned_rates` is held to the JAX package in law on the same
seeds (the two packages' streams differ).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import eval as t_eval_cli
from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.agents import agent_lib as t_agent_lib
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.agents import vision_planner as t_vp
from putting_dune_tpu import eval as j_eval_cli
from putting_dune_tpu import eval_lib as j_eval_lib
from putting_dune_tpu import run_helpers as j_run_helpers
from putting_dune_tpu.agents import agent_lib as j_agent_lib
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.agents import planner as j_planner
from putting_dune_tpu.experiments import registry as j_registry

torch.set_num_threads(2)

BOND = 1.42
# The sixteen entries over the rate stack (the rest were ported before).
NEW_ENTRIES = (
    'relative_random_prior_rates', 'planner_prior_rates',
    'greedy_prior_rates', 'planner_learned_rates',
    'planner_prior_rates_variable_time', 'planner_distilled_prior',
    'planner_distilled_prior_variable_time', 'greedy_aligned_prior_rates',
    'vision_planner_prior_rates', 'vision_planner_learned_rates',
    'eval_ppo_learned_tf_2s', 'eval_ppo_learned_tf_3s',
    'eval_ppo_learned_tf_4s', 'eval_ppo_v3_2s', 'eval_ppo_v3_3s',
    'eval_ppo_v3_4s')
VISION = ('vision_planner_prior_rates', 'vision_planner_learned_rates')


def _t(x):
  return torch.from_numpy(np.array(x))


def test_all_jax_single_dopant_names_are_ported():
  want = set(j_registry.eval_experiment_names())
  assert len(want) == 27
  assert set(t_registry.eval_experiment_names()) == want
  assert set(NEW_ENTRIES) <= want


@pytest.mark.parametrize('name', sorted(j_registry.eval_experiment_names()))
def test_compositions_equal_jax(name):
  _assert_same_composition(t_registry.create_eval_experiment(name),
                           j_registry.create_eval_experiment(name))


def test_all_jax_train_names_are_ported():
  assert t_registry.train_experiment_names() == (
      j_registry.train_experiment_names())
  assert len(t_registry.train_experiment_names()) == 12
  with pytest.raises(ValueError, match='Unknown train experiment'):
    t_registry.create_train_experiment('ppo_learned_5s')


@pytest.mark.parametrize('name', j_registry.train_experiment_names())
def test_train_compositions_equal_jax(name):
  _assert_same_composition(t_registry.create_train_experiment(name),
                           j_registry.create_train_experiment(name))


@pytest.mark.parametrize('name', [
    'direct_simple_rates_from_images',
    'relative_simple_rates_from_images_variable_time', 'ppo_v3_4s'])
def test_train_envs_step_on_the_cpu(name):
  exp = t_registry.create_train_experiment(name)
  envir = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=3,
      image_size=64, device='cpu')
  spec = envir.action_spec()
  gen = torch.Generator().manual_seed(0)
  state, ts = envir.reset(gen)
  for _ in range(2):
    low = torch.as_tensor(spec.minimum, dtype=torch.float32)
    high = torch.as_tensor(spec.maximum, dtype=torch.float32)
    action = low + (high - low) * torch.rand((3,) + spec.shape, generator=gen)
    state, ts = envir.step(state, action, gen)
  assert bool(torch.isfinite(ts.reward).all())


def _assert_same_composition(t_exp, j_exp):
  t_spec, j_spec = t_exp.get_simulator_config(), j_exp.get_simulator_config()
  assert t_spec.rate_fn.__name__ == j_spec.rate_fn.__name__
  assert t_spec.image_duration_seconds == j_spec.image_duration_seconds
  assert t_spec.drift_per_frame_angstroms == j_spec.drift_per_frame_angstroms
  t_parts, j_parts = t_exp.get_adapters_and_goal(), j_exp.get_adapters_and_goal()
  for part in ('action_adapter', 'feature_constructor'):
    t_obj, j_obj = getattr(t_parts, part), getattr(j_parts, part)
    assert type(t_obj).__name__ == type(j_obj).__name__, part
    for field in dataclasses.fields(t_obj):
      assert getattr(t_obj, field.name) == pytest.approx(
          getattr(j_obj, field.name)), (part, field.name)


def _agents(name):
  t_exp = t_registry.create_eval_experiment(name)
  j_exp = j_registry.create_eval_experiment(name)
  t_agent = t_exp.get_policy(t_exp.get_adapters_and_goal(), 'cpu')
  j_agent = j_exp.get_agent(np.random.default_rng(0),
                            j_exp.get_adapters_and_goal())
  return t_agent, j_agent


def _rate_inputs(seed, n=256):
  rng = np.random.default_rng(seed)
  si = (rng.normal(size=(n, 2)) * 3).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, (n, 1)) + np.array([0, 2.094, 4.189])
  nbr = (si[:, None, :] + BOND * np.stack(
      [np.cos(angle), np.sin(angle)], -1)).astype(np.float32)
  beam = (si + rng.normal(size=(n, 2)) * 1.5).astype(np.float32)
  return si, nbr, beam


def _same_rate_law(t_fn, j_fn):
  si, nbr, beam = _rate_inputs(3)
  want = np.asarray(j_fn(jnp.asarray(si), jnp.asarray(nbr),
                         jnp.asarray(beam)))
  got = t_fn(_t(si), _t(nbr), _t(beam)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('name', [
    'planner_prior_rates', 'planner_learned_rates',
    'planner_prior_rates_variable_time'])
def test_planner_agents_equal_jax(name):
  t_agent, j_agent = _agents(name)
  assert isinstance(t_agent, t_planner.PlannerAgent)
  assert isinstance(j_agent, j_planner.PlannerAgent)
  for field in ('dwell_seconds', 'lookahead_discount', 'dwell_range_seconds',
                'dwell_objective', 'num_radii', 'num_angles'):
    assert getattr(t_agent, field) == getattr(j_agent, field), field
  if name == 'planner_learned_rates':
    _same_rate_law(t_agent.rate_fn, j_agent.rate_fn)
  else:
    assert t_agent.rate_fn.__name__ == j_agent.rate_fn.__name__


@pytest.mark.parametrize('name', ['greedy_prior_rates',
                                  'greedy_aligned_prior_rates'])
def test_greedy_agents_equal_jax(name):
  t_policy, j_agent = _agents(name)
  assert isinstance(j_agent, j_agent_lib.GreedyAgent)
  assert t_policy.func is t_agent_lib.greedy_policy
  np.testing.assert_allclose(t_policy.keywords['argmax'], j_agent._argmax)


def test_random_prior_agent_equals_jax():
  t_policy, j_agent = _agents('relative_random_prior_rates')
  assert isinstance(j_agent, j_agent_lib.UniformRandomAgent)
  assert t_policy.func is t_agent_lib.uniform_random_policy
  assert t_policy.keywords['low'] == j_agent._low
  assert t_policy.keywords['high'] == j_agent._high
  assert (t_policy.keywords['action_dim'],) == j_agent._size


@pytest.mark.parametrize('name,checkpoint,action_dim', [
    ('planner_distilled_prior', 'planner_distilled_prior', 2),
    ('eval_ppo_learned_tf_2s', '230127_from_state_2s', 3),
    ('eval_ppo_learned_tf_3s', '230127_from_state_3s', 3),
    ('eval_ppo_learned_tf_4s', '230127_from_state_4s', 3),
    ('eval_ppo_v3_2s', '230422_ppo_v3_2s', 3),
    ('eval_ppo_v3_3s', '230422_ppo_v3_3s', 3),
    ('eval_ppo_v3_4s', '230422_ppo_v3_4s', 3)])
def test_checkpoint_agents_act_as_jax(name, checkpoint, action_dim):
  t_policy, j_agent = _agents(name)
  assert isinstance(j_agent, j_eval_agent.EvalAgent)
  assert os.path.isdir(os.path.join(t_eval_agent.MODEL_WEIGHTS_DIR,
                                    checkpoint))
  rng = np.random.default_rng(4)
  obs = rng.uniform(-6, 6, (64, 10)).astype(np.float32)
  want = np.asarray(j_agent.policy()(None, jnp.asarray(obs)))
  got = t_policy(None, _t(obs)).numpy()
  assert got.shape == want.shape == (64, action_dim)
  # A tanh tower of width 256 in f32 (output scale up to 3.3): 1e-5.
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('name', VISION)
def test_vision_agents_equal_jax(name):
  t_agent, j_agent = _agents(name)
  assert isinstance(t_agent, t_vp.VisionPlannerAgent)
  assert t_agent.dwell_seconds == j_agent.dwell_seconds == 5.0
  assert t_agent.max_distance_angstroms == pytest.approx(
      j_agent.max_distance_angstroms)
  if name == 'vision_planner_learned_rates':
    _same_rate_law(t_agent.rate_fn, j_agent.rate_fn)
  else:
    assert t_agent.rate_fn.__name__ == j_agent.rate_fn.__name__ == (
        'prior_rates_aligned')


def test_missing_checkpoint_raises_as_in_jax():
  name = 'planner_distilled_prior_variable_time'
  with pytest.raises(FileNotFoundError):
    _ = j_registry.create_eval_experiment(name).get_agent(
        None, j_registry.create_eval_experiment(name).get_adapters_and_goal())
  exp = t_registry.create_eval_experiment(name)
  with pytest.raises(FileNotFoundError):
    exp.get_policy(exp.get_adapters_and_goal(), 'cpu')


def test_shipped_rate_model_raises_when_absent(monkeypatch, tmp_path):
  monkeypatch.setattr(t_eval_agent, 'MODEL_WEIGHTS_DIR', str(tmp_path))
  with pytest.raises(FileNotFoundError, match='rate predictor'):
    t_registry._load_shipped_rate_fn('cpu')
  exp = t_registry.create_eval_experiment('planner_learned_rates')
  with pytest.raises(FileNotFoundError):
    exp.get_policy(exp.get_adapters_and_goal(), 'cpu')


def test_register_eval_experiment_adds_once():
  exp = t_registry.create_eval_experiment('planner_prior_rates')
  other = t_registry.create_eval_experiment('greedy_prior_rates')
  try:
    t_registry.register_eval_experiment('my_planner', exp)
    t_registry.register_eval_experiment('my_planner', other)
    assert t_registry.create_eval_experiment('my_planner') is exp
    t_registry.register_eval_experiment('planner_prior_rates', other)
    assert t_registry.create_eval_experiment('planner_prior_rates') is exp
  finally:
    t_registry._EVAL_EXPERIMENTS.pop('my_planner', None)


@pytest.mark.parametrize('name', [
    n for n in NEW_ENTRIES
    if n not in VISION and n != 'planner_distilled_prior_variable_time'])
def test_new_vector_entries_step_on_the_cpu(name):
  exp = t_registry.create_eval_experiment(name)
  parts = exp.get_adapters_and_goal()
  policy = t_eval_cli.policy_for_agent(exp.get_policy(parts, 'cpu'))
  envir = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=4,
      device='cpu')
  gen = torch.Generator().manual_seed(0)
  state, ts = envir.reset(gen)
  for _ in range(2):
    action = policy(gen, ts.observation)
    assert action.shape == (4, parts.action_adapter.spec().shape[0])
    assert bool(torch.isfinite(action).all())
    state, ts = envir.step(state, action, gen)
  assert bool(torch.isfinite(ts.reward).all())


def _z(p1, p2, n1, n2):
  p = (p1 * n1 + p2 * n2) / (n1 + n2)
  se = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
  return (p1 - p2) / se if se > 0 else 0.0


def test_planner_learned_rates_matches_jax_in_distribution():
  # Both packages on 100 seeds on the CPU: success within 4 standard
  # errors of each other, and the actions to goal too.
  seeds = tuple(range(100))
  name = 'planner_learned_rates'
  exp = j_registry.create_eval_experiment(name)
  agent = exp.get_agent(np.random.default_rng(0), exp.get_adapters_and_goal())
  j_envir = j_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds))
  want = j_eval_lib.evaluate_batched(
      j_envir, j_eval_cli._policy_for_agent(agent, j_envir), seeds)
  t_exp = t_registry.create_eval_experiment(name)
  t_envir = t_run_helpers.create_batched_env(
      t_exp.get_adapters_and_goal, t_exp.get_simulator_config,
      batch_size=len(seeds), device='cpu')
  got = t_eval_lib.evaluate_batched(
      t_envir,
      t_exp.get_policy(t_exp.get_adapters_and_goal(), 'cpu').policy(), seeds)
  j_ok = np.array([r.reached_goal for r in want])
  t_ok = np.array([r.reached_goal for r in got])
  assert t_ok.mean() >= 0.9
  assert abs(_z(t_ok.mean(), j_ok.mean(), len(seeds), len(seeds))) < 4.0
  j_act = np.array([r.num_actions_taken for r in want])[j_ok]
  t_act = np.array([r.num_actions_taken for r in got])[t_ok]
  se = np.hypot(j_act.std(ddof=1) / np.sqrt(len(j_act)),
                t_act.std(ddof=1) / np.sqrt(len(t_act)))
  assert abs(t_act.mean() - j_act.mean()) / se < 4.0


@pytest.mark.parametrize('name', VISION)
def test_vision_entries_step_on_the_cpu(name):
  # Two env steps of the pixels -> UNet -> lattice frame -> planner loop
  # at a small render (64^2 frames here; 512^2 on the card).
  exp = t_registry.create_eval_experiment(name)
  parts = exp.get_adapters_and_goal()
  policy = t_eval_cli.policy_for_agent(exp.get_policy(parts, 'cpu'))
  envir = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2,
      image_size=64, device='cpu')
  gen = torch.Generator().manual_seed(1)
  state, ts = envir.reset(gen)
  assert ts.observation['image'].shape == (2, 256, 256, 1)
  for _ in range(2):
    action = policy(gen, ts.observation)
    assert action.shape == (2, 2) and bool(torch.isfinite(action).all())
    assert float(action.abs().max()) <= 1.0
    state, ts = envir.step(state, action, gen)
