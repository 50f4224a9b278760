"""PPO on the batched environment (port of putting_dune_tpu/agents/ppo.py).

The actor-critic: vector observations (B, D) go straight to a tanh MLP
tower; image observations {'image': (B, H, W, 1), 'goal_delta_angstroms':
(B, G)} first go through 3x3 stride-2 convolutions with flax's 'SAME'
padding and ReLU, flattened in NHWC order and concatenated with the goal
delta. The tower feeds a tanh mean head, a state-independent log_std and a
value head. Fresh modules start from flax's initialisers (lecun_normal
kernels, zero biases, log_std -0.5), so a run learns as the JAX one does.

The trainer (`PPOTrainer`, and `make_train_fns`, `make_train` and
`train_and_save` over it) is the JAX package's program as a Python loop
over one `torch.Generator` on the env's device: rollouts with
potential-based shaping, GAE over the env's
per-step discounts, `num_epochs` x `num_minibatches` clipped-objective
steps over a permutation, optax's `clip_by_global_norm` then Adam. The
rollout buffer stays on the device and nothing is read back per step. The
action noises and the permutations are drawn from the generator unless the
caller passes them (`run_updates(..., noise=, perms=)`), which is how the
tests hold a whole update to the JAX package.

Precision: on CUDA the forward passes and the whole update, backward
included, run under `cudnn.flags(enabled=True, allow_tf32=False)`, so the
convolutions and their gradients compute in full float32 as the JAX
package does on the CPU; matmuls follow `torch.backends.cuda.matmul.
allow_tf32`, which PyTorch leaves off.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from putting_dune_torch import constants
from putting_dune_torch.rate_learning import model as model_lib

METRIC_NAMES = ('loss', 'mean_reward', 'terminal_rate', 'mean_value')


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
  """flax/XLA 'SAME': out = ceil(size / stride), extra pad at the end."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def conv_encode(convs: Sequence[nn.Conv2d], image: torch.Tensor,
                activation) -> torch.Tensor:
  """(B, H, W, C) NHWC frames through 3x3 stride-2 'SAME' convolutions,
  each followed by `activation`, flattened in NHWC order."""
  x = image.permute(0, 3, 1, 2)
  with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
    for conv in convs:
      ph = _same_padding(x.shape[-2], 3, 2)
      pw = _same_padding(x.shape[-1], 3, 2)
      x = activation(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
  return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def conv_output_size(image_size: int, num_layers: int) -> int:
  for _ in range(num_layers):
    image_size = -(-image_size // 2)
  return image_size


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
  """flax's initialisers in place: lecun_normal kernels (fan_in = inputs x
  receptive field), zero biases, log_std (where there is one) -0.5.
  LayerNorms keep torch's (and flax's) ones and zeros."""
  for layer in model.modules():
    if isinstance(layer, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
      # A transposed convolution's weight is (in, out, kh, kw).
      fan_in = (layer.weight[:, 0].numel()
                if isinstance(layer, nn.ConvTranspose2d)
                else layer.weight[0].numel())
      model_lib.lecun_normal_(layer.weight, generator, fan_in=fan_in)
      with torch.no_grad():
        layer.bias.zero_()
  if isinstance(getattr(model, 'log_std', None), nn.Parameter):
    with torch.no_grad():
      model.log_std.fill_(-0.5)
  return model


class ActorCritic(nn.Module):
  """Gaussian policy + value head over vector or image-dict observations.

  obs_dim set: vector observations of that width. Otherwise image
  observations of `image_size`^2 pixels with a `goal_dim` goal delta.
  """

  def __init__(
      self,
      action_dim: int = 2,
      hidden: Sequence[int] = (256, 256),
      conv_features: Sequence[int] = (16, 32, 64),
      image_size: int = 128,
      *,
      obs_dim: Optional[int] = None,
      goal_dim: int = 2,
  ):
    super().__init__()
    self.action_dim = int(action_dim)
    self.hidden_sizes = tuple(int(h) for h in hidden)
    self.conv_features = tuple(int(f) for f in conv_features)
    self.image_size = int(image_size)
    self.obs_dim = obs_dim
    self.convs = nn.ModuleList()
    if obs_dim is None:
      channels = 1
      for f in self.conv_features:
        self.convs.append(nn.Conv2d(channels, f, 3, stride=2, padding=0))
        channels = f
      size = conv_output_size(self.image_size, len(self.conv_features))
      in_features = channels * size * size + goal_dim
    else:
      in_features = int(obs_dim)
    self.hidden = nn.ModuleList()
    for width in self.hidden_sizes:
      self.hidden.append(nn.Linear(in_features, width))
      in_features = width
    self.policy_mean = nn.Linear(in_features, action_dim)
    self.value = nn.Linear(in_features, 1)
    self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))

  @property
  def takes_images(self) -> bool:
    return self.obs_dim is None

  def forward(self, obs):
    if isinstance(obs, Mapping):
      x = torch.cat([conv_encode(self.convs, obs['image'], F.relu),
                     obs['goal_delta_angstroms']], dim=-1)
    else:
      x = obs
    for layer in self.hidden:
      x = torch.tanh(layer(x))
    mean = torch.tanh(self.policy_mean(x))
    value = self.value(x)[..., 0]
    return mean, self.log_std.expand_as(mean), value


def _goal_delta(obs):
  """The goal-delta feature (angstroms) of either observation layout."""
  if isinstance(obs, Mapping):
    return obs['goal_delta_angstroms']
  return obs[..., -2:]  # both vector feature layouts end with the goal delta


@dataclasses.dataclass(frozen=True)
class PPOConfig:
  num_updates: int = 200
  rollout_length: int = 64
  learning_rate: float = 3e-4
  gamma_fallback: float = 0.99  # unused: the env supplies per-step discounts
  gae_lambda: float = 0.95
  clip_epsilon: float = 0.2
  value_coef: float = 0.5
  entropy_coef: float = 1e-3
  num_epochs: int = 4
  num_minibatches: int = 8
  max_grad_norm: float = 0.5
  hidden: Tuple[int, ...] = (256, 256)
  conv_features: Tuple[int, ...] = (16, 32, 64)
  # Potential-based reward shaping (training only): adds
  # discount * phi(s') - phi(s) with phi = -coef * distance / bond, which
  # keeps the optimal policy (Ng et al., 1999) while densifying the sparse
  # goal reward. 0 disables it.
  reward_shaping_coef: float = 0.0


def _gaussian_logprob(mean, log_std, action):
  var = torch.exp(2 * log_std)
  return torch.sum(
      -0.5 * torch.square(action - mean) / var
      - log_std
      - 0.5 * math.log(2 * math.pi),
      dim=-1,
  )


def _gaussian_entropy(log_std):
  return torch.mean(
      torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1))


# -- flax layout ------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
  return t.detach().to('cpu', torch.float32).numpy().copy()


def flax_dense(layer: nn.Linear) -> dict:
  return {'kernel': _np(layer.weight).T.copy(), 'bias': _np(layer.bias)}


def flax_conv(conv: nn.Conv2d) -> dict:
  return {'kernel': _np(conv.weight).transpose(2, 3, 1, 0).copy(),
          'bias': _np(conv.bias)}


def _copy_(target: torch.Tensor, value, name: str) -> None:
  value = torch.from_numpy(np.array(value, dtype=np.float32))
  if tuple(value.shape) != tuple(target.shape):
    raise ValueError(f'{name}: shape {tuple(value.shape)} does not fit '
                     f'{tuple(target.shape)}')
  with torch.no_grad():
    target.copy_(value.to(target.device))


def copy_dense_(layer: nn.Linear, params: Mapping[str, Any], name: str
                ) -> None:
  """A flax Dense (kernel (in, out)) into an nn.Linear ((out, in))."""
  _copy_(layer.weight, np.asarray(params['kernel']).T, f'{name}/kernel')
  _copy_(layer.bias, params['bias'], f'{name}/bias')


def copy_conv_(conv: nn.Conv2d, params: Mapping[str, Any], name: str) -> None:
  """A flax Conv (kernel HWIO) into an nn.Conv2d (OIHW)."""
  _copy_(conv.weight, np.asarray(params['kernel']).transpose(3, 2, 0, 1),
         f'{name}/kernel')
  _copy_(conv.bias, params['bias'], f'{name}/bias')


def indexed_names(params, prefix: str) -> list[str]:
  return sorted((k for k in params if k.startswith(prefix)),
                key=lambda k: int(k.split('_')[1]))


def actor_critic_to_flax(model: ActorCritic) -> dict:
  """The flax ActorCritic parameter tree of `model`: conv kernels OIHW ->
  HWIO, Dense kernels (out, in) -> (in, out)."""
  params = {f'conv_{f}': flax_conv(conv)
            for f, conv in zip(model.conv_features, model.convs)}
  for i, layer in enumerate(model.hidden):
    params[f'Dense_{i}'] = flax_dense(layer)
  params['policy_mean'] = flax_dense(model.policy_mean)
  params['log_std'] = _np(model.log_std)
  params['value'] = flax_dense(model.value)
  return params


def load_actor_critic_params_(model: ActorCritic,
                              params: Mapping[str, Mapping[str, Any]]
                              ) -> ActorCritic:
  """Copies a flax ActorCritic tree into `model`; raises ValueError where a
  name is missing or a shape does not fit."""
  names = ([f'conv_{f}' for f in model.conv_features]
           + [f'Dense_{i}' for i in range(len(model.hidden))]
           + ['policy_mean', 'value', 'log_std'])
  missing = [n for n in names if n not in params]
  if missing or len(indexed_names(params, 'Dense_')) != len(model.hidden):
    raise ValueError(f'actor-critic parameters: missing {missing}, or the '
                     f'tower is not {len(model.hidden)} layers deep')
  for f, conv in zip(model.conv_features, model.convs):
    copy_conv_(conv, params[f'conv_{f}'], f'conv_{f}')
  for i, layer in enumerate(model.hidden):
    copy_dense_(layer, params[f'Dense_{i}'], f'Dense_{i}')
  copy_dense_(model.policy_mean, params['policy_mean'], 'policy_mean')
  copy_dense_(model.value, params['value'], 'value')
  _copy_(model.log_std, params['log_std'], 'log_std')
  return model


def actor_critic_from_flax(
    params: Mapping[str, Mapping[str, np.ndarray]],
    *,
    image_size: int = 128,
) -> ActorCritic:
  """Builds an ActorCritic holding flax ActorCritic parameters; a tree
  without `conv_*` layers is the vector-observation model."""
  conv_names = indexed_names(params, 'conv_')
  dense_names = indexed_names(params, 'Dense_')
  conv_features = [params[k]['kernel'].shape[-1] for k in conv_names]
  hidden = [params[k]['kernel'].shape[-1] for k in dense_names]
  action_dim = params['policy_mean']['kernel'].shape[-1]
  in_features = params[dense_names[0]]['kernel'].shape[0]
  if conv_names:
    size = conv_output_size(image_size, len(conv_features))
    model = ActorCritic(action_dim, hidden, conv_features, image_size,
                        goal_dim=in_features - conv_features[-1] * size**2)
  else:
    model = ActorCritic(action_dim, hidden, (), obs_dim=in_features)
  return load_actor_critic_params_(model, params).eval()


# -- the trainer --------------------------------------------------------------


@dataclasses.dataclass
class TrainCarry:
  """What one chunk of updates hands the next: the model, its optimizer,
  the env state and timestep, and the run's generator."""

  model: ActorCritic
  optimizer: torch.optim.Optimizer
  env_state: Any
  ts: Any
  gen: torch.Generator


def _obs_spec_model(env, config: PPOConfig) -> ActorCritic:
  action_dim = env.action_spec().shape[0]
  spec = env.observation_spec()
  if isinstance(spec, Mapping):
    return ActorCritic(action_dim, config.hidden, config.conv_features,
                       spec['image'].shape[0],
                       goal_dim=spec['goal_delta_angstroms'].shape[0])
  return ActorCritic(action_dim, config.hidden, (), obs_dim=spec.shape[0])


def make_optimizer(model: nn.Module, learning_rate: float):
  """optax.adam(learning_rate): b1 0.9, b2 0.999, eps 1e-8, no decay."""
  return torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
  """optax.clip_by_global_norm on the gradients of `params`, in place:
  each gradient becomes (g / norm) * max_norm when the global norm is not
  below max_norm, and stays otherwise. No host sync. Returns the norm."""
  grads = [p.grad for p in params if p.grad is not None]
  norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
  keep = norm < max_norm
  for g in grads:
    g.copy_(torch.where(keep, g, g / norm * max_norm))
  return norm


def _stack(items):
  if isinstance(items[0], Mapping):
    return {k: torch.stack([o[k] for o in items]) for k in items[0]}
  return torch.stack(items)


def _flatten(x, n):
  if isinstance(x, Mapping):
    return {k: v.reshape((n,) + v.shape[2:]) for k, v in x.items()}
  return x.reshape((n,) + x.shape[2:])


def _take(x, idx):
  if isinstance(x, Mapping):
    return {k: v[idx] for k, v in x.items()}
  return x[idx]


class PPOTrainer:
  """The PPO program on `env`'s device, in its two phases.

  init_carry(seed, init_params=None) -> TrainCarry: a fresh model with
  flax's initialisers (or, for a warm start, the given flax ActorCritic
  tree), Adam, and a reset env, all from one generator seeded with `seed`
  (an int) or from the generator passed.

  rollout(carry, noise=None) -> (traj, last_value): `rollout_length` env
  steps under the current policy, stacked on the device; `noise`
  (rollout_length, B, action_dim) replaces the drawn action noises.

  learn(carry, traj, last_value, perms=None) -> metrics: GAE, then
  `num_epochs` x `num_minibatches` clipped-objective Adam steps; `perms`
  (num_epochs, rollout_length * B) replaces the drawn permutations.

  run_updates(carry, num_updates, noise=None, perms=None) -> (carry,
  metrics) runs whole updates (with the draws above stacked per update)
  and returns each metric as a (num_updates,) tensor on the device.
  """

  def __init__(self, env, config: PPOConfig = PPOConfig()):
    self.env = env
    self.config = config
    self.device = env.device
    self.batch = env.batch_size
    self.n = config.rollout_length * self.batch
    self.mb_size = self.n // config.num_minibatches
    self.shaping = (config.reward_shaping_coef
                    / constants.CARBON_BOND_DISTANCE_ANGSTROMS)
    if hasattr(env, 'shaping_distance'):
      self.distance = env.shaping_distance
    else:
      self.distance = lambda o: torch.linalg.vector_norm(_goal_delta(o),
                                                         dim=-1)

  def init_carry(self, seed, init_params=None) -> TrainCarry:
    gen = seed
    if not isinstance(seed, torch.Generator):
      gen = torch.Generator(device=self.device)
      gen.manual_seed(int(seed))
    model = _obs_spec_model(self.env, self.config).to(self.device)
    flax_init_(model, gen)
    if init_params is not None:
      load_actor_critic_params_(model, init_params)
    env_state, ts = self.env.reset(gen)
    return TrainCarry(model, make_optimizer(model, self.config.learning_rate),
                      env_state, ts, gen)

  def rollout(self, carry: TrainCarry, noise=None):
    model, gen, env = carry.model, carry.gen, self.env
    state, ts = carry.env_state, carry.ts
    steps = []
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
      for t in range(self.config.rollout_length):
        mean, log_std, value = model(ts.observation)
        eps = (noise[t] if noise is not None else torch.randn(
            mean.shape, generator=gen, device=self.device))
        action = mean + torch.exp(log_std) * eps
        logprob = _gaussian_logprob(mean, log_std, action)
        next_state, next_ts = env.step(state, action, gen)
        reward = next_ts.reward
        if self.shaping:
          # Skipped across auto-resets (s' starts the next episode); a
          # terminal's discount 0 drops phi(s').
          phi_s = -self.shaping * self.distance(ts.observation)
          phi_sp = -self.shaping * self.distance(next_ts.observation)
          shaped = next_ts.discount * phi_sp - phi_s
          reward = reward + torch.where(next_ts.first(),
                                        torch.zeros_like(shaped), shaped)
        steps.append((ts.observation, action, logprob, value, reward,
                      next_ts.discount, next_ts.first()))
        state, ts = next_state, next_ts
      _, _, last_value = model(ts.observation)
    carry.env_state, carry.ts = state, ts
    traj = {k: _stack([s[i] for s in steps]) for i, k in enumerate(
        ('obs', 'action', 'logprob', 'value', 'reward', 'discount',
         'next_is_first'))}
    return traj, last_value

  def _advantages(self, traj, last_value):
    """GAE with the env's per-step discount; no bootstrap across a FIRST
    step."""
    adv = torch.empty_like(traj['value'])
    gae = torch.zeros((self.batch,), device=self.device)
    next_value = last_value
    for t in reversed(range(self.config.rollout_length)):
      boot = torch.where(traj['next_is_first'][t],
                         torch.zeros_like(gae), traj['discount'][t])
      delta = traj['reward'][t] + boot * next_value - traj['value'][t]
      gae = delta + boot * self.config.gae_lambda * gae
      adv[t] = gae
      next_value = traj['value'][t]
    return adv

  def _loss(self, model, mb):
    config = self.config
    mean, log_std, value = model(mb['obs'])
    logprob = _gaussian_logprob(mean, log_std, mb['action'])
    ratio = torch.exp(logprob - mb['logprob'])
    adv = mb['advantage']
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - config.clip_epsilon,
                          1 + config.clip_epsilon) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = 0.5 * torch.mean(torch.square(value - mb['return']))
    return (policy_loss + config.value_coef * value_loss
            - config.entropy_coef * _gaussian_entropy(log_std))

  def learn(self, carry: TrainCarry, traj, last_value, perms=None):
    config, n, mb_size = self.config, self.n, self.mb_size
    adv = self._advantages(traj, last_value)
    flat = {k: _flatten(traj[k], n) for k in ('obs', 'action', 'logprob')}
    flat['advantage'] = adv.reshape(n)
    flat['return'] = (adv + traj['value']).reshape(n)
    model, optimizer = carry.model, carry.optimizer
    params = list(model.parameters())
    epoch_losses = []
    # The backward's convolutions too run in full float32.
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
      for e in range(config.num_epochs):
        perm = (perms[e] if perms is not None else torch.randperm(
            n, generator=carry.gen, device=self.device))
        idx = perm[: mb_size * config.num_minibatches].reshape(
            config.num_minibatches, mb_size)
        losses = []
        for i in range(config.num_minibatches):
          loss = self._loss(model,
                            {k: _take(v, idx[i]) for k, v in flat.items()})
          optimizer.zero_grad(set_to_none=True)
          loss.backward()
          clip_by_global_norm_(params, config.max_grad_norm)
          optimizer.step()
          losses.append(loss.detach())
        epoch_losses.append(torch.stack(losses).mean())
    return {
        'loss': torch.stack(epoch_losses).mean(),
        'mean_reward': traj['reward'].mean(),
        'terminal_rate': (traj['discount'] == 0.0).to(torch.float32).mean(),
        'mean_value': traj['value'].mean(),
    }

  def run_updates(self, carry: TrainCarry, num_updates: int, noise=None,
                  perms=None):
    rows = []
    for u in range(num_updates):
      traj, last_value = self.rollout(
          carry, None if noise is None else noise[u])
      rows.append(self.learn(carry, traj, last_value,
                             None if perms is None else perms[u]))
    return carry, {k: torch.stack([r[k] for r in rows]) for k in METRIC_NAMES}


def make_train_fns(env, config: PPOConfig = PPOConfig()):
  """(init_carry, run_updates) of a PPOTrainer on `env`, for chunked
  training (see PPOTrainer)."""
  trainer = PPOTrainer(env, config)
  return trainer.init_carry, trainer.run_updates


def make_train(env, config: PPOConfig = PPOConfig()):
  """Returns train(seed, init_params=None) -> (model, metrics): the whole
  run of `config.num_updates` updates in one call."""
  init_carry, run_updates = make_train_fns(env, config)

  def train(seed, init_params=None):
    carry, metrics = run_updates(init_carry(seed, init_params),
                                 config.num_updates)
    return carry.model, metrics

  return train


def as_policy(model: ActorCritic, env, config: PPOConfig) -> nn.Module:
  """The saveable policy of a trained actor-critic: for image envs the
  whole actor-critic (its mean head acts; an 'actor_critic' checkpoint);
  for vector envs an MLPPolicy holding the tower and the mean head (an
  'mlp' checkpoint at output scale 1, without the critic)."""
  from putting_dune_torch.agents import eval_agent  # eval_agent imports us

  if isinstance(env.observation_spec(), Mapping):
    policy = _obs_spec_model(env, config).to(env.device)
    policy.load_state_dict(model.state_dict())
    return policy.eval()
  policy = eval_agent.MLPPolicy(
      obs_dim=model.obs_dim, hidden=config.hidden,
      action_dim=env.action_spec().shape[0]).to(env.device)
  with torch.no_grad():
    for dst, src in zip(policy.hidden, model.hidden):
      dst.load_state_dict(src.state_dict())
    policy.out.load_state_dict(model.policy_mean.state_dict())
  return policy.eval()


def as_eval_agent(model: ActorCritic, env, config: PPOConfig):
  """Trained ActorCritic weights as a saveable `eval_agent.EvalAgent`
  (an 'actor_critic' policy for image observations, an 'mlp' one
  otherwise; see `as_policy`)."""
  from putting_dune_torch.agents import eval_agent  # eval_agent imports us

  return eval_agent.EvalAgent(as_policy(model, env, config))


def train_and_save(
    env,
    save_dir: str,
    config: PPOConfig = PPOConfig(),
    seed: int = 0,
    updates_per_chunk: Optional[int] = None,
    max_wall_seconds: Optional[float] = None,
    log_every_chunk: bool = False,
    init_params_from: Optional[str] = None,
):
  """Trains PPO on `env` (on its device) and saves the policy checkpoint
  (`eval_agent.save_policy`); returns (policy module, metrics as numpy).

  With updates_per_chunk set, training runs in chunks of that many
  updates, saving a rolling checkpoint to save_dir after each and stopping
  once max_wall_seconds is exceeded. Without it, all updates are one chunk
  and the policy is saved once.

  init_params_from warm-starts from a saved 'actor_critic' checkpoint
  directory. 'mlp' checkpoints keep the actor tower but drop the critic
  at save time, so they cannot seed PPO and are rejected.
  """
  from putting_dune_torch.agents import eval_agent  # eval_agent imports us

  init_params = None
  if init_params_from:
    with open(os.path.join(init_params_from, 'policy.json')) as f:
      kind = json.load(f)['kind']
    if kind != 'actor_critic':
      raise ValueError(
          f'init_params_from supports actor_critic checkpoints only, got '
          f'{kind!r} at {init_params_from} (mlp checkpoints keep the actor '
          f'tower but drop the critic).')
    init_params = eval_agent.read_flax_params(
        os.path.join(init_params_from, 'policy.ckpt'))

  init_carry, run_updates = make_train_fns(env, config)
  carry = init_carry(seed, init_params)
  chunk = updates_per_chunk or config.num_updates
  chunks = []
  done = 0
  t0 = time.monotonic()
  while done < config.num_updates:
    count = min(chunk, config.num_updates - done)
    carry, metrics = run_updates(carry, count)
    # Reading the metrics waits for the chunk to finish.
    chunks.append({k: v.cpu().numpy() for k, v in metrics.items()})
    done += count
    policy = as_policy(carry.model, env, config)
    eval_agent.save_policy(policy, save_dir)
    elapsed = time.monotonic() - t0
    if log_every_chunk:
      print(f"ppo: {done}/{config.num_updates} updates, {elapsed:.0f}s, "
            f"loss={chunks[-1]['loss'][-1]:.4f} terminal_rate="
            f"{float(np.mean(chunks[-1]['terminal_rate'])):.4f}", flush=True)
    if max_wall_seconds is not None and elapsed > max_wall_seconds:
      break
  metrics = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
  return policy, metrics
