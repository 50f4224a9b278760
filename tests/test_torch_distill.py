"""The port's DAgger distiller against the JAX package, on the CPU.

Two whole iterations on the deterministic toy env (tests/torch_toy_env.py,
and in jax.numpy tests/jax_toy_env.py) with a deterministic
teacher, the JAX key chain replayed to give the port the same mix uniforms
and minibatch indices: student parameters and losses within 1e-5. Then
the real paths: the default planner teacher with variable dwell, the
multi-dopant planner as an external teacher, and save -> load in both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_toy_env
import torch_toy_env
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.agents import distill as t_distill
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import planner as t_planner
from putting_dune_torch.env import multi_dopant as t_md
from putting_dune_tpu.agents import distill as j_distill
from putting_dune_tpu.agents import eval_agent as j_eval_agent

torch.set_num_threads(2)

BOND = 1.42


def _jax_teacher(obs):
  return jnp.tanh(1.3 * obs[:, 4:6] + 0.2 * obs[:, 2:4])


def _replay_distill_draws(seed, config, batch):
  """The mix uniforms and SGD indices `run_iteration` draws from
  PRNGKey(seed) after `init_carry` (putting_dune_tpu/agents/distill.py)."""
  key, _, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
  out = []
  filled = 0
  for _ in range(config.num_iterations):
    mix = []
    for _ in range(config.rollout_length):
      key, k_mix, _ = jax.random.split(key, 3)
      mix.append(np.asarray(jax.random.uniform(k_mix, (batch, 1))))
    filled += config.rollout_length * batch
    idx = []
    for _ in range(config.sgd_steps_per_iteration):
      key, k_idx = jax.random.split(key)
      idx.append(np.asarray(jax.random.randint(
          k_idx, (config.minibatch_size,), 0, filled)))
    out.append((torch.from_numpy(np.asarray(mix)),
                torch.from_numpy(np.asarray(idx)).long()))
  return out


def test_two_dagger_iterations_match_jax():
  table = torch_toy_env.starts(16, seed=3)
  config = j_distill.DistillConfig(
      num_iterations=2, rollout_length=4, sgd_steps_per_iteration=6,
      minibatch_size=32, learning_rate=1e-3, hidden=(16, 16),
      output_scale=1.0)
  t_config = t_distill.DistillConfig(**{
      f: getattr(config, f) for f in config.__dataclass_fields__})
  init_carry, run_iteration, _ = j_distill.make_distill_fns(
      jax_toy_env.JaxToyEnv(table), None, config, teacher=_jax_teacher)
  j_carry = init_carry(jax.random.PRNGKey(0))
  init_params = jax.tree_util.tree_map(np.asarray, j_carry['params'])
  t_init, t_run = t_distill.make_distill_fns(
      torch_toy_env.ToyEnv(table), None, t_config,
      teacher=torch_toy_env.teacher)
  carry = t_init(11, init_params)
  draws = _replay_distill_draws(0, config, 16)
  for i in range(config.num_iterations):
    beta = config.teacher_mix_init * config.teacher_mix_decay**i
    j_carry, j_metrics = run_iteration(j_carry, jnp.float32(beta))
    mix, idx = draws[i]
    carry, t_metrics = t_run(carry, beta, mix=mix, indices=idx)
    assert abs(float(t_metrics['loss']) - float(j_metrics['loss'])) <= 1e-5
    assert carry.filled == int(j_carry['filled'])
  np.testing.assert_allclose(carry.buf_act.numpy(),
                             np.asarray(j_carry['buf_act']), atol=1e-6)
  got = t_eval_agent.policy_to_flax(carry.model)
  want = jax.tree_util.tree_map(np.asarray, j_carry['params'])
  assert torch_toy_env.max_tree_diff(got, want) <= 1e-5
  # The student moved by more than the tolerance.
  assert torch_toy_env.max_tree_diff(init_params, want) > 1e-4


def _material_env(batch, name='planner_prior_rates_variable_time'):
  exp = t_registry.create_eval_experiment(name)
  return t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=batch,
      device='cpu')


def test_variable_dwell_student_tracks_the_planner(tmp_path):
  env = _material_env(16)
  config = t_distill.DistillConfig(
      num_iterations=2, rollout_length=6, sgd_steps_per_iteration=60,
      minibatch_size=128, learning_rate=3e-3, hidden=(32, 32), num_radii=5,
      num_angles=16, dwell_range_seconds=(1.5, 20.0))
  progress = []
  model = t_distill.train_and_save(
      env, str(tmp_path), t_rates.prior_rates, config,
      progress=lambda i, m: progress.append(m))
  assert [m['beta'] for m in progress] == [1.0, 0.5]
  assert progress[-1]['loss'] < progress[0]['loss'] or progress[-1][
      'loss'] < 0.5
  _, ts = env.reset(torch.Generator().manual_seed(5))
  teach = t_distill.default_teacher(t_rates.prior_rates, config)(
      ts.observation)
  with torch.no_grad():
    student = model(ts.observation)
  assert student.shape == teach.shape == (16, 3)
  # Per-dim scales: angstrom deltas up to 3.3, the dwell fraction up to 1.
  assert float(student[:, 2].abs().max()) <= 1.0 + 1e-6
  assert float((student[:, 2] - teach[:, 2]).abs().mean()) < 0.45
  # The checkpoint loads in both packages and acts the same.
  obs = ts.observation.numpy()
  loaded = t_eval_agent.load_policy(str(tmp_path), 'cpu')
  agent = j_eval_agent.EvalAgent.load(str(tmp_path))
  got = t_eval_agent.mean_policy(loaded)(None, ts.observation).numpy()
  assert np.array_equal(got, student.numpy())
  assert float(np.abs(np.asarray(agent.policy()(None, jnp.asarray(obs)))
                      - got).max()) <= 1e-6


def test_external_multi_dopant_teacher():
  env = t_md.MultiDopantEnv(
      lattice=t_lattice.make_lattice(20, 'cpu'),
      rate_fn=t_rates.simple_canonical_rates, batch_size=8, num_dopants=2,
      dwell_seconds=5.0, observation_mode='vector_neighbors', device='cpu')
  agent = t_planner.MultiDopantPlannerAgent(
      rate_fn=t_rates.simple_canonical_rates, num_dopants=2,
      dwell_seconds=5.0, max_distance_angstroms=2 * BOND, num_radii=5,
      num_angles=16)
  teacher = agent.policy()
  config = t_distill.DistillConfig(
      num_iterations=2, rollout_length=8, sgd_steps_per_iteration=50,
      minibatch_size=128, hidden=(32, 32), output_scale=1.0)
  model, metrics = t_distill.distill(
      env, None, config, seed=0, teacher=lambda obs: teacher(None, obs))
  losses = metrics['loss']
  assert np.isfinite(losses).all() and losses[-1] < losses[0]
  _, ts = env.reset(torch.Generator().manual_seed(2))
  with torch.no_grad():
    out = model(ts.observation)
  assert out.shape == (8, 2) and float(out.abs().max()) <= 1.0 + 1e-6


def test_distill_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    exp = t_registry.create_eval_experiment('planner_prior_rates')
    t_run_helpers.create_batched_env(
        exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2)
  # On the CPU when asked: the buffer and the student live on the env's
  # device.
  env = _material_env(2, 'planner_prior_rates')
  init_carry, _ = t_distill.make_distill_fns(
      env, t_rates.prior_rates, t_distill.DistillConfig(
          num_iterations=1, rollout_length=2, hidden=(8,)))
  carry = init_carry(0)
  assert carry.buf_obs.shape == (4, 10) and carry.buf_obs.device.type == 'cpu'
  assert next(carry.model.parameters()).device.type == 'cpu'
