"""The port's PPO trainer on the real envs, against the JAX package, on the
CPU: the learning curve in law on relative_simple_rates, chunked and shaped
training, the saved checkpoints in both packages, pixel and multi-dopant
training, the train CLI and the entry points' device.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_toy_env
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_torch import registry as t_registry
from putting_dune_torch import run_helpers as t_run_helpers
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import ppo as t_ppo
from putting_dune_torch.env import multi_dopant as t_md
from putting_dune_tpu import run_helpers as j_run_helpers
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.agents import ppo as j_ppo
from putting_dune_tpu.experiments import registry as j_registry

torch.set_num_threads(2)


def _actions_jax(agent, obs):
  return np.asarray(agent.policy()(
      None, jax.tree_util.tree_map(jnp.asarray, obs)))


def _actions_port(model, obs):
  return t_eval_agent.mean_policy(model)(None, torch.from_numpy(obs)).numpy()


# --- the trainer on the real envs --------------------------------------------


def _train_env(name, batch, device='cpu', **kwargs):
  exp = t_registry.create_train_experiment(name)
  return t_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=batch,
      device=device, **kwargs)


# Learning shows within 20 updates at this rate with shaping: at 3e-4 and
# no shaping most seeds reach no goal by update 20 (measured in the JAX
# package), and the test would compare zeros.
LAW_CONFIG = dict(num_updates=20, rollout_length=16, hidden=(32, 32),
                  learning_rate=3e-3, reward_shaping_coef=0.05)
LAW_SEEDS = (0, 1, 2, 3)


def test_trainer_matches_jax_in_law():
  """Per-seed mean terminal rate over the last 5 of 20 updates on
  relative_simple_rates (batch 64), 4 seeds each: Welch z < 3."""
  exp = j_registry.create_train_experiment('relative_simple_rates')
  j_env = j_run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=64)
  train, _ = j_ppo.make_train(j_env, j_ppo.PPOConfig(**LAW_CONFIG))
  j_rates = [float(np.asarray(train(jax.random.PRNGKey(s))[1][
      'terminal_rate'])[-5:].mean()) for s in LAW_SEEDS]
  env = _train_env('relative_simple_rates', 64)
  t_train = t_ppo.make_train(env, t_ppo.PPOConfig(**LAW_CONFIG))
  t_rates_ = [float(t_train(s)[1]['terminal_rate'][-5:].mean())
              for s in LAW_SEEDS]
  n = len(LAW_SEEDS)
  se = math.sqrt(np.var(j_rates, ddof=1) / n + np.var(t_rates_, ddof=1) / n)
  z = (np.mean(t_rates_) - np.mean(j_rates)) / max(se, 1e-9)
  assert abs(z) < 3, (j_rates, t_rates_, z)
  assert np.mean(j_rates) > 0 and np.mean(t_rates_) > 0


def test_chunked_and_shaped_training_and_cli_checkpoint(tmp_path):
  env = _train_env('relative_simple_rates', 16)
  config = t_ppo.PPOConfig(num_updates=3, rollout_length=4, hidden=(16,),
                           num_epochs=1, num_minibatches=2,
                           reward_shaping_coef=0.05)
  policy, metrics = t_ppo.train_and_save(env, str(tmp_path / 'p'), config,
                                         seed=1, updates_per_chunk=2)
  assert all(v.shape == (3,) for v in metrics.values())
  assert np.isfinite(metrics['loss']).all()
  assert np.abs(metrics['mean_reward']).min() > 0  # shaped: dense reward
  assert isinstance(policy, t_eval_agent.MLPPolicy)
  # The port-trained policy loads and acts in the JAX package.
  agent = j_eval_agent.EvalAgent.load(str(tmp_path / 'p'))
  _, ts = env.reset(torch.Generator().manual_seed(0))
  obs = ts.observation.numpy()
  got = _actions_port(policy, obs)
  assert float(np.abs(_actions_jax(agent, obs) - got).max()) <= 1e-6
  # An mlp cannot seed a warm start, in either package.
  with pytest.raises(ValueError, match='actor_critic'):
    t_ppo.train_and_save(env, str(tmp_path / 'q'), config,
                         init_params_from=str(tmp_path / 'p'))


def test_pixel_trainer_saves_and_warm_starts(tmp_path):
  env = _train_env('relative_simple_rates_from_images', 4, image_size=64)
  config = t_ppo.PPOConfig(num_updates=2, rollout_length=3, hidden=(16,),
                           num_epochs=1, num_minibatches=2,
                           reward_shaping_coef=0.05)
  policy, metrics = t_ppo.train_and_save(env, str(tmp_path / 'p'), config)
  assert np.isfinite(metrics['loss']).all()
  assert isinstance(policy, t_ppo.ActorCritic) and policy.takes_images
  loaded = t_eval_agent.load_policy(str(tmp_path / 'p'), 'cpu')
  init_carry, _ = t_ppo.make_train_fns(env, config)
  carry = init_carry(9, t_eval_agent.read_flax_params(
      str(tmp_path / 'p' / 'policy.ckpt')))
  assert torch_toy_env.max_tree_diff(t_ppo.actor_critic_to_flax(carry.model),
                   t_ppo.actor_critic_to_flax(loaded)) == 0.0


@pytest.mark.parametrize('mode', ['vector', 'image'])
def test_multi_dopant_trainer_runs(mode):
  env = t_md.MultiDopantEnv(
      lattice=t_lattice.make_lattice(20, 'cpu'),
      rate_fn=t_rates.simple_canonical_rates, batch_size=4, num_dopants=2,
      dwell_seconds=5.0, observation_mode=mode, image_size=32, device='cpu')
  config = t_ppo.PPOConfig(num_updates=2, rollout_length=3, hidden=(16,),
                           num_epochs=1, num_minibatches=2,
                           reward_shaping_coef=0.05)
  train = t_ppo.make_train(env, config)
  model, metrics = train(0)
  assert model.takes_images == (mode == 'image')
  assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
  assert float(metrics['mean_reward'].abs().min()) > 0


def test_train_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    _train_env('relative_simple_rates', 2, device=None)
  from putting_dune_torch.agents import train_ppo
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    train_ppo.main(['--workdir', '/nonexistent', '--num_updates=1'])


def test_cli_trains_saves_and_evaluates(tmp_path):
  from putting_dune_torch.agents import train_ppo
  workdir = tmp_path / 'run'
  out = train_ppo.main([
      '--train_experiment=relative_simple_rates', f'--workdir={workdir}',
      '--batch_size=16', '--num_updates=2', '--rollout_length=4',
      '--eval_suite=tiny_eval', '--device=cpu'])
  assert sorted(os.listdir(workdir)) == ['eval.json', 'policy',
                                         'train_metrics.npz']
  assert sorted(os.listdir(workdir / 'policy')) == ['policy.ckpt',
                                                   'policy.json']
  saved = np.load(workdir / 'train_metrics.npz')
  assert saved['loss'].shape == (2,)
  with open(workdir / 'eval.json') as f:
    assert json.load(f) == out['eval']
  with pytest.raises(ValueError, match='mesh'):
    train_ppo.main([f'--workdir={tmp_path / "m"}', '--mesh=model:2',
                    '--device=cpu'])
