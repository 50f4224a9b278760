"""The host loop of putting_dune_torch against the JAX package, on the CPU:
the host agents, the dm_env wrapper, the host evaluator and the eval CLI's
--nobatched / --seed / --output_json."""

import dataclasses
import datetime as dt
import json
import math
import types

import numpy as np
import pytest
import torch

from putting_dune_torch import eval as t_eval_cli
from putting_dune_torch import eval_lib as t_eval_lib
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.agents import agent_lib as t_agent_lib
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.env import dm_env_wrapper as t_wrapper
from putting_dune_tpu import eval as j_eval_cli
from putting_dune_tpu.agents import agent_lib as j_agent_lib

torch.set_num_threads(4)


class _Step:

  def __init__(self, observation):
    self.observation = observation


def _observations(seed, n):
  """10-dim material-frame features: silicon, three neighbour deltas at
  120 degrees, a goal delta."""
  rng = np.random.default_rng(seed)
  angle = rng.uniform(0, 2 * np.pi, (n, 1)) + np.asarray([0, 2.094, 4.189])
  deltas = 1.42 * np.stack([np.cos(angle), np.sin(angle)], -1)
  return np.concatenate([
      rng.normal(size=(n, 2)) * 5, deltas.reshape(n, 6),
      rng.normal(size=(n, 2)) * 4], -1).astype(np.float32)


def test_find_argmax_equals_jax():

  def transition(p):
    d = np.linalg.norm(np.asarray(p) - np.asarray([0.9, 0.2]))
    return np.asarray([np.exp(-d), 0.1, 0.0])

  want = j_agent_lib.find_argmax(transition, 0.25)
  np.testing.assert_array_equal(t_agent_lib.find_argmax(transition, 0.25),
                                want)
  # Tensors from the function work too.
  np.testing.assert_array_equal(
      t_agent_lib.find_argmax(lambda p: torch.as_tensor(transition(p)), 0.25),
      want)


def test_uniform_random_agent_draws_equal_jax():
  t_agent = t_agent_lib.UniformRandomAgent(
      np.random.default_rng(7), np.asarray([-1.0, -1.0, 0.0]), 1.0, (3,))
  j_agent = j_agent_lib.UniformRandomAgent(
      np.random.default_rng(7), np.asarray([-1.0, -1.0, 0.0]), 1.0, (3,))
  for _ in range(20):
    np.testing.assert_array_equal(t_agent.step(None), j_agent.step(None))


@pytest.mark.parametrize('argmax,offset', [((1.42, 0.0), (0.0, 0.0)),
                                           ((0.58, 0.0), (0.1, -0.3)),
                                           ((2.1717172, -0.15151516),
                                            (0.0, 0.0))])
def test_greedy_agent_without_noise_equals_jax(argmax, offset):
  t_agent = t_agent_lib.GreedyAgent(argmax=np.asarray(argmax),
                                    fixed_offset=np.asarray(offset),
                                    device='cpu')
  j_agent = j_agent_lib.GreedyAgent(argmax=np.asarray(argmax),
                                    fixed_offset=np.asarray(offset))
  for obs in _observations(1, 16):
    np.testing.assert_allclose(t_agent.step(_Step(obs)),
                               j_agent.step(_Step(obs)), atol=1e-5)


def test_greedy_agent_noise_in_law():
  """sigma = 0.3: the beam offsets of both agents, rotated back to the
  canonical frame, are N(argmax + offset, 0.3^2) per axis; their means and
  variances agree by z-tests, and each step draws one integer from the
  caller's generator."""
  obs = _observations(2, 1)[0]
  n = 400
  samples = {}
  for name, lib, kwargs in (('torch', t_agent_lib, {'device': 'cpu'}),
                            ('jax', j_agent_lib, {})):
    rng = np.random.default_rng(11)
    agent = lib.GreedyAgent(rng=rng, position_noise_sigma=0.3,
                            fixed_offset=np.asarray([0.2, 0.0]), **kwargs)
    samples[name] = np.stack([agent.step(_Step(obs)) for _ in range(n)])
    check = np.random.default_rng(11)
    for _ in range(n):
      check.integers(2**31)
    assert rng.integers(2**31) == check.integers(2**31)
  noiseless = j_agent_lib.GreedyAgent(
      fixed_offset=np.asarray([0.2, 0.0])).step(_Step(obs))
  for name, x in samples.items():
    d = x - noiseless
    assert np.abs(d.mean(0)).max() < 4 * 0.3 / math.sqrt(n), name
    assert np.abs(d.std(0) - 0.3).max() < 4 * 0.3 / math.sqrt(2 * n), name
  a, b = samples['torch'], samples['jax']
  z = (a.mean(0) - b.mean(0)) / np.sqrt(a.var(0) / n + b.var(0) / n)
  assert np.abs(z).max() < 4.0


def test_planner_agent_step_equals_its_batched_policy():
  exp = t_registry.create_eval_experiment('planner_simple_rates')
  agent = t_registry.host_agent(exp, np.random.default_rng(0),
                                exp.get_adapters_and_goal(), 'cpu')
  assert isinstance(agent, t_planner.PlannerAgent)
  obs = _observations(3, 8)
  batched = agent.policy()(None, torch.from_numpy(obs)).numpy()
  for i in range(len(obs)):
    np.testing.assert_allclose(agent.step(_Step(obs[i])), batched[i],
                               atol=1e-6)


def test_host_agents_of_the_registry():
  rng = np.random.default_rng(0)
  for name, kind in (('relative_random_simple', t_agent_lib.UniformRandomAgent),
                     ('greedy_simple_rates', t_agent_lib.GreedyAgent),
                     ('planner_distilled_prior', t_agent_lib.Agent)):
    exp = t_registry.create_eval_experiment(name)
    agent = t_registry.host_agent(exp, rng, exp.get_adapters_and_goal(),
                                  'cpu')
    assert isinstance(agent, kind), name
  exp = t_registry.create_eval_experiment('vision_planner_simple_rates')
  with pytest.raises(NotImplementedError, match='host step'):
    t_registry.host_agent(exp, rng, exp.get_adapters_and_goal(), 'cpu')


# --- the dm_env wrapper ---------------------------------------------------------


def _wrapper(name='relative_random_simple', seed=3, step_limit=20):
  exp = t_registry.create_eval_experiment(name)
  return t_run_helpers.create_putting_dune_env(
      seed, exp.get_adapters_and_goal, exp.get_simulator_config,
      simulator_step_limit=step_limit, device='cpu')


def _assert_valid(env, step):
  assert isinstance(step, t_wrapper.TimeStep)
  assert isinstance(step.step_type, t_wrapper.StepType)
  if step.first():
    assert step.reward is None and step.discount is None
  else:
    env.reward_spec().validate(step.reward)
    env.discount_spec().validate(step.discount)
  spec = env.observation_spec()
  if isinstance(spec, dict):
    assert set(spec) == set(step.observation)
    for key, value in step.observation.items():
      spec[key].validate(value)
  else:
    spec.validate(step.observation)


def test_wrapper_follows_the_dm_env_contract():
  env = _wrapper()
  for _ in range(2):
    first = env.reset()
    _assert_valid(env, first)
    assert first.first()
  # Step on a fresh environment is a reset; the next one is not FIRST.
  env = _wrapper()
  action = env.action_spec().generate_value()
  assert env.step(action).first()
  assert not env.step(action).first()
  # A long sequence: FIRST only ever follows LAST; the step limit ends
  # episodes.
  rng = np.random.default_rng(0)
  spec = env.action_spec()
  saw_last = False
  for _ in range(2):
    step = env.reset()
    prev = step.step_type
    for _ in range(45):
      step = env.step(rng.uniform(spec.minimum, spec.maximum, spec.shape))
      _assert_valid(env, step)
      if prev is t_wrapper.StepType.LAST:
        assert step.first()
      else:
        assert not step.first()
      saw_last |= step.last()
      prev = step.step_type
  assert saw_last
  assert env.last_elapsed_seconds > 0


def test_wrapper_seed_replays_and_refuses_batches():
  a, b = _wrapper(seed=5), _wrapper(seed=9)
  first = a.reset()
  a.seed(5)
  np.testing.assert_array_equal(a.reset().observation, first.observation)
  assert not np.array_equal(b.reset().observation, first.observation)
  exp = t_registry.create_eval_experiment('relative_random_simple')
  batched = t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2,
      device='cpu')
  with pytest.raises(ValueError, match='batch_size=1'):
    t_wrapper.DmEnvWrapper(batched)


def test_wrapper_image_observations_match_the_spec():
  env = _wrapper('ppo_simple_images_tf')
  env.env.config = dataclasses.replace(
      env.env.config, sim=dataclasses.replace(env.env.config.sim,
                                              image_size=128))
  step = env.reset()
  assert set(step.observation) == {'image', 'goal_delta_angstroms'}
  _assert_valid(env, step)
  _assert_valid(env, env.step(np.zeros(2)))


def test_evaluate_refuses_video(tmp_path):
  # The host evaluator now writes one GIF a seed: a frame for the reset
  # and one a step.
  from putting_dune_torch.io import gif

  agent = types.SimpleNamespace(set_mode=lambda mode: None,
                                step=lambda ts: np.zeros(2, np.float32))
  env = _wrapper()
  (result,) = t_eval_lib.evaluate(agent, env, [0],
                                  timeout=dt.timedelta(seconds=40),
                                  video_save_dir=str(tmp_path))
  with open(tmp_path / '0.gif', 'rb') as f:
    video = gif.decode(f.read(), limit=1)
  assert video.count == result.num_actions_taken + 1
  assert video.frames[0].shape == (500, 500, 3)


# --- the host evaluator and the CLI ------------------------------------------------


@pytest.fixture(scope='module')
def host_payloads(tmp_path_factory):
  """greedy_simple_rates on small_eval through both CLIs, --nobatched."""
  out = tmp_path_factory.mktemp('host')
  j_eval_cli.main(j_eval_cli.Args(
      experiment_name='greedy_simple_rates', eval_suite='small_eval',
      batched=False, seed=1, output_json=str(out / 'jax.json')))
  t_eval_cli.cli([
      '--experiment_name=greedy_simple_rates', '--eval_suite=small_eval',
      '--nobatched', '--seed=1', f'--output_json={out / "torch.json"}',
      '--device=cpu'])
  with open(out / 'jax.json') as f:
    jax_payload = json.load(f)
  with open(out / 'torch.json') as f:
    torch_payload = json.load(f)
  return jax_payload, torch_payload


def _z(a, b):
  a, b = np.asarray(a, float), np.asarray(b, float)
  se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
  return 0.0 if se == 0 else (a.mean() - b.mean()) / se


def test_cli_nobatched_payload_has_the_jax_keys(host_payloads):
  jax_payload, torch_payload = host_payloads
  assert list(torch_payload) == list(jax_payload)
  assert list(torch_payload['aggregate']) == list(jax_payload['aggregate'])
  assert list(torch_payload['results'][0]) == list(jax_payload['results'][0])
  assert torch_payload['aggregate']['evaluator'] == 'host(wall+sim-time)'
  assert [r['seed'] for r in torch_payload['results']] == list(range(100))


def test_host_evaluate_matches_jax_and_the_batched_law(host_payloads):
  jax_payload, torch_payload = host_payloads
  j_res, t_res = jax_payload['results'], torch_payload['results']
  assert _z([r['reached_goal'] for r in t_res],
            [r['reached_goal'] for r in j_res]) == 0.0  # all reach it
  assert abs(_z([r['num_actions_taken'] for r in t_res],
                [r['num_actions_taken'] for r in j_res])) < 3.0
  # The port's batched evaluator on the same suite reads the same law.
  report = t_eval_cli.main(t_eval_cli.Args(
      experiment_name='greedy_simple_rates', eval_suite='small_eval',
      device='cpu'))
  batched = report['results']
  assert all(r.reached_goal for r in batched)
  assert abs(_z([r.num_actions_taken for r in batched],
                [r['num_actions_taken'] for r in t_res])) < 3.0


def test_cli_mesh_with_nobatched_raises():
  with pytest.raises(ValueError, match='requires batched'):
    t_eval_cli.main(t_eval_cli.Args(
        experiment_name='greedy_simple_rates', batched=False, mesh='data',
        device='cpu'))
  with pytest.raises(ValueError, match='Unknown mesh axis'):
    t_eval_cli.main(t_eval_cli.Args(
        experiment_name='greedy_simple_rates', mesh='model:2', device='cpu'))
