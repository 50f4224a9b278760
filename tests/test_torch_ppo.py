"""The port's PPO trainer and policy checkpoints against the JAX package, on
the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in putting_dune_torch. Forward passes are held within
1e-6; two whole PPO updates on a deterministic toy env (written twice:
tests/torch_toy_env.py and tests/jax_toy_env.py), with the JAX key chain
replayed to give the port the same action noises and permutations, within
1e-5; the optimizer within 1e-6; checkpoints of every kind across the
packages, within 1e-6. Training on the real envs:
tests/test_torch_ppo_train.py.
"""

import json
import math

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax_toy_env
import torch_toy_env
from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.agents import ppo as t_ppo
from putting_dune_tpu.agents import eval_agent as j_eval_agent
from putting_dune_tpu.agents import ppo as j_ppo

torch.set_num_threads(2)


# --- forward passes ----------------------------------------------------------


def _image_obs(rng, b, size, goal_dim=2):
  return {'image': rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
          'goal_delta_angstroms': (rng.normal(size=(b, goal_dim)) * 4).astype(
              np.float32)}


def _torch_obs(obs):
  if isinstance(obs, dict):
    return {k: torch.from_numpy(v) for k, v in obs.items()}
  return torch.from_numpy(obs)


@pytest.mark.parametrize('kind', ['vector', 'image', 'image_multi_dopant'])
def test_actor_critic_forward_matches_flax(kind):
  rng = np.random.default_rng(0)
  module = j_ppo.ActorCritic(action_dim=3 if kind == 'vector' else 2,
                             hidden=(32, 24), conv_features=(8, 16, 32))
  if kind == 'vector':
    obs = rng.normal(size=(5, 10)).astype(np.float32)
  else:
    obs = _image_obs(rng, 5, 40, 4 if kind == 'image_multi_dopant' else 2)
  j_obs = jax.tree_util.tree_map(jnp.asarray, obs)
  params = module.init(jax.random.PRNGKey(1), j_obs)['params']
  want = module.apply({'params': params}, j_obs)
  model = t_ppo.actor_critic_from_flax(
      jax.tree_util.tree_map(np.asarray, params), image_size=40)
  assert model.takes_images == (kind != 'vector')
  with torch.no_grad():
    got = model(_torch_obs(obs))
  for g, w in zip(got, want):
    assert g.shape == w.shape
    assert float(np.abs(g.detach().numpy() - np.asarray(w)).max()) <= 1e-6


def test_conv_policy_forward_matches_flax():
  rng = np.random.default_rng(2)
  module = j_eval_agent.ConvPolicy(hidden=(32,), action_dim=2,
                                   features=(8, 16, 32))
  obs = _image_obs(rng, 4, 128)
  j_obs = jax.tree_util.tree_map(jnp.asarray, obs)
  params = module.init(jax.random.PRNGKey(3), j_obs)['params']
  want = np.asarray(module.apply({'params': params}, j_obs))
  model = t_eval_agent.conv_policy_from_flax(
      jax.tree_util.tree_map(np.asarray, params))
  with torch.no_grad():
    got = model(_torch_obs(obs)).numpy()
  assert float(np.abs(got - want).max()) <= 1e-6


def test_gaussian_logprob_and_entropy_match_jax():
  # The rollout's regime: actions drawn around the mean at the policy's
  # std, log_std near its initial -0.5.
  rng = np.random.default_rng(4)
  mean = np.tanh(rng.normal(size=(64, 3))).astype(np.float32)
  log_std = rng.uniform(-1.0, 0.0, (64, 3)).astype(np.float32)
  action = (mean + np.exp(log_std) * rng.normal(size=(64, 3))).astype(
      np.float32)
  want = np.asarray(j_ppo._gaussian_logprob(mean, log_std, action))
  got = t_ppo._gaussian_logprob(*map(torch.from_numpy,
                                     (mean, log_std, action))).numpy()
  assert float(np.abs(got - want).max()) <= 1e-6
  want_h = float(jnp.mean(jnp.sum(log_std + 0.5 * jnp.log(
      2 * jnp.pi * jnp.e), axis=-1)))
  got_h = float(t_ppo._gaussian_entropy(torch.from_numpy(log_std)))
  assert abs(got_h - want_h) <= 1e-6


@pytest.mark.parametrize('kind', ['vector', 'image'])
def test_fresh_modules_start_from_flax_initialisers(kind):
  # lecun_normal: a normal truncated at +-2 std with variance 1 / fan_in;
  # zero biases; log_std -0.5.
  gen = torch.Generator().manual_seed(0)
  if kind == 'vector':
    model = t_ppo.ActorCritic(2, (512, 512), (), obs_dim=400)
    layer, fan_in = model.hidden[1].weight, 512
  else:
    model = t_ppo.ActorCritic(2, (64,), (16, 64, 64), 32)
    layer, fan_in = model.convs[2].weight, 16 * 9 * 4
  t_ppo.flax_init_(model, gen)
  w = layer.detach().numpy()
  assert abs(w.var() * fan_in - 1.0) < 0.05
  assert np.abs(w).max() <= 2.0 / 0.8796256610342398 / math.sqrt(fan_in) + 1e-6
  assert all(float(m.bias.detach().abs().max()) == 0.0
             for m in model.modules()
             if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)))
  assert model.log_std.detach().tolist() == [-0.5, -0.5]


# --- the optimizer -----------------------------------------------------------


@pytest.mark.parametrize('steps', [1, 20])
def test_clip_and_adam_match_optax(steps):
  rng = np.random.default_rng(steps)
  shapes = {'a': (7, 5), 'b': (5,), 'log_std': (2,)}
  params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
  opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
  j_params = jax.tree_util.tree_map(jnp.asarray, params)
  j_state = opt.init(j_params)
  t_params = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
              for k in shapes]
  t_opt = torch.optim.Adam(t_params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
  model = torch.nn.Module()
  for name, p in zip(shapes, t_params):
    model.register_parameter(name, p)
  assert [g['lr'] for g in t_ppo.make_optimizer(model, 3e-4).param_groups] == [
      3e-4]
  for i in range(steps):
    # Global norms on both sides of 0.5: clipped and kept.
    scale = 0.01 if i % 3 == 0 else 1.0
    grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
    updates, j_state = opt.update(
        jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
    j_params = optax.apply_updates(j_params, updates)
    for k, p in zip(shapes, t_params):
      p.grad = torch.from_numpy(grads[k].copy())
    norm = t_ppo.clip_by_global_norm_(t_params, 0.5)
    assert abs(float(norm) - float(optax.global_norm(grads))) <= 1e-6
    t_opt.step()
  for k, p in zip(shapes, t_params):
    assert float(np.abs(p.detach().numpy() - np.asarray(j_params[k])).max()
                 ) <= 1e-6


# --- two whole updates -------------------------------------------------------


def _replay_ppo_draws(seed, config, num_updates, batch, action_dim):
  """The action noises and permutations `run_updates` draws from
  PRNGKey(seed) after `init_carry` (putting_dune_tpu/agents/ppo.py)."""
  key, _, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
  n = config.rollout_length * batch
  noise, perms = [], []
  for _ in range(num_updates):
    rows = []
    for _ in range(config.rollout_length):
      key, k_act, _ = jax.random.split(key, 3)
      rows.append(np.asarray(jax.random.normal(k_act, (batch, action_dim))))
    noise.append(rows)
    epochs = []
    for _ in range(config.num_epochs):
      key, k_perm = jax.random.split(key)
      epochs.append(np.asarray(jax.random.permutation(k_perm, n)))
    perms.append(epochs)
  return (torch.from_numpy(np.asarray(noise)),
          torch.from_numpy(np.asarray(perms)).long())


PPO_TOY = j_ppo.PPOConfig(hidden=(32, 32), rollout_length=8, num_epochs=2,
                          num_minibatches=2, reward_shaping_coef=0.05)


def test_two_ppo_updates_match_jax():
  table = torch_toy_env.starts(16)
  j_env = jax_toy_env.JaxToyEnv(table)
  t_env = torch_toy_env.ToyEnv(table)
  config = PPO_TOY
  t_config = t_ppo.PPOConfig(**{
      f: getattr(config, f) for f in config.__dataclass_fields__})
  init_params = j_ppo.ActorCritic(hidden=config.hidden).init(
      jax.random.PRNGKey(7), jnp.zeros((1, 6)))['params']
  init_carry, run_updates, _ = j_ppo.make_train_fns(j_env, config)
  j_carry, j_metrics = run_updates(
      init_carry(jax.random.PRNGKey(0), init_params), 2)
  noise, perms = _replay_ppo_draws(0, config, 2, 16, 2)

  t_init, t_run = t_ppo.make_train_fns(t_env, t_config)
  carry = t_init(5, jax.tree_util.tree_map(np.asarray, init_params))
  carry, t_metrics = t_run(carry, 2, noise=noise, perms=perms)
  assert float(np.asarray(j_metrics['terminal_rate']).max()) > 0  # terminals
  for name in t_ppo.METRIC_NAMES:
    np.testing.assert_allclose(t_metrics[name].numpy(),
                               np.asarray(j_metrics[name]), atol=1e-5, rtol=0)
  diff = torch_toy_env.max_tree_diff(t_ppo.actor_critic_to_flax(carry.model),
                   jax.tree_util.tree_map(np.asarray, j_carry[0]))
  assert diff <= 1e-5
  # The update moved the parameters by more than the tolerance.
  assert torch_toy_env.max_tree_diff(
      jax.tree_util.tree_map(np.asarray, init_params),
      jax.tree_util.tree_map(np.asarray, j_carry[0])) > 1e-4


def test_warm_start_keeps_the_params_exactly():
  table = torch_toy_env.starts(4)
  t_init, _ = t_ppo.make_train_fns(torch_toy_env.ToyEnv(table),
                                   t_ppo.PPOConfig(hidden=(16, 8)))
  params = jax.tree_util.tree_map(
      np.asarray, j_ppo.ActorCritic(hidden=(16, 8)).init(
          jax.random.PRNGKey(2), jnp.zeros((1, 6)))['params'])
  carry = t_init(0, params)
  assert torch_toy_env.max_tree_diff(
      t_ppo.actor_critic_to_flax(carry.model), params) == 0.0
  with pytest.raises(ValueError, match='shape'):
    t_init(0, {**params, 'value': {'kernel': np.zeros((4, 1), np.float32),
                                   'bias': np.zeros((1,), np.float32)}})


# --- checkpoints across the packages -----------------------------------------


def _jax_modules():
  return {
      'mlp': (j_eval_agent.MLPPolicy(hidden=(32, 16), action_dim=3,
                                     output_scale=(3.3, 3.3, 1.0)),
              lambda rng: rng.normal(size=(6, 10)).astype(np.float32) * 2),
      'conv': (j_eval_agent.ConvPolicy(hidden=(32,), action_dim=2,
                                       features=(8, 16, 32)),
               lambda rng: _image_obs(rng, 3, 128)),
      'actor_critic': (None, lambda rng: _image_obs(rng, 3, 64)),
  }


def _actions_jax(agent, obs):
  return np.asarray(agent.policy()(
      None, jax.tree_util.tree_map(jnp.asarray, obs)))


def _actions_port(model, obs):
  return t_eval_agent.mean_policy(model)(None, _torch_obs(obs)).numpy()


@pytest.mark.parametrize('kind', ['mlp', 'conv', 'actor_critic'])
def test_jax_checkpoints_load_in_the_port(kind, tmp_path):
  rng = np.random.default_rng(5)
  module, make_obs = _jax_modules()[kind]
  obs = make_obs(rng)
  j_obs = jax.tree_util.tree_map(jnp.asarray, obs)
  if kind == 'actor_critic':
    ac = j_ppo.ActorCritic(hidden=(32, 16), conv_features=(8, 16, 32))
    agent = j_eval_agent.EvalAgent.from_actor_critic(
        ac.init(jax.random.PRNGKey(1), j_obs)['params'], hidden=(32, 16),
        conv_features=(8, 16, 32), action_dim=2, image_size=64)
  else:
    agent = j_eval_agent.EvalAgent(
        module, module.init(jax.random.PRNGKey(1), j_obs)['params'])
  agent.save(str(tmp_path))
  model = t_eval_agent.load_policy(str(tmp_path), 'cpu')
  got, want = _actions_port(model, obs), _actions_jax(agent, obs)
  assert got.shape == want.shape
  assert float(np.abs(got - want).max()) <= 1e-6


def _port_module(kind):
  gen = torch.Generator().manual_seed(3)
  if kind == 'mlp':
    model = t_eval_agent.MLPPolicy(10, (32, 16), 3,
                                   output_scale=[3.3, 3.3, 1.0])
  elif kind == 'conv':
    model = t_eval_agent.ConvPolicy((32,), 2, (8, 16, 32))
  else:
    model = t_ppo.ActorCritic(2, (32, 16), (8, 16, 32), 64)
  t_ppo.flax_init_(model, gen)
  with torch.no_grad():  # biases away from 0, so the layout is tested
    for p in model.parameters():
      p.add_(0.01 * torch.randn(p.shape, generator=gen))
  return model.eval()


@pytest.mark.parametrize('kind', ['mlp', 'conv', 'actor_critic'])
def test_port_checkpoints_load_in_jax(kind, tmp_path):
  rng = np.random.default_rng(6)
  obs = _jax_modules()[kind][1](rng)
  model = _port_module(kind)
  t_eval_agent.save_policy(model, str(tmp_path))
  with open(tmp_path / 'policy.json') as f:
    assert json.load(f)['kind'] == kind
  agent = j_eval_agent.EvalAgent.load(str(tmp_path))
  got, want = _actions_port(model, obs), _actions_jax(agent, obs)
  assert float(np.abs(got - want).max()) <= 1e-6
  # The port reads back what it wrote.
  again = t_eval_agent.load_policy(str(tmp_path), 'cpu')
  assert float(np.abs(_actions_port(again, obs) - got).max()) == 0.0


def test_port_checkpoint_bytes_equal_flax(tmp_path):
  model = _port_module('actor_critic')
  t_eval_agent.save_policy(model, str(tmp_path))
  params = t_eval_agent.policy_to_flax(model)
  want = flax.serialization.to_bytes(params)
  assert (tmp_path / 'policy.ckpt').read_bytes() == want


def test_vector_actor_critic_is_saved_as_its_mlp(tmp_path):
  model = t_ppo.ActorCritic(2, (8,), (), obs_dim=10)
  with pytest.raises(ValueError, match='mlp'):
    t_eval_agent.save_policy(model, str(tmp_path))
