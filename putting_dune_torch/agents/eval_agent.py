"""Frozen-policy loading (port of putting_dune_tpu/agents/eval_agent.py).

A checkpoint directory holds `policy.json` (kind + architecture) and
`policy.ckpt` (flax msgpack parameters). The shipped weights under
putting_dune_tpu/experiments/model_weights/ are read in place, as data.
Three kinds, each a module here:

  * 'mlp': MLPPolicy, the vector-observation tanh tower (the PPO actor's
    layout);
  * 'conv': ConvPolicy, a dict-observation conv policy (swish);
  * 'actor_critic': a whole PPO ActorCritic (agents/ppo.py), whose mean
    head acts (image policies).

`load_policy` reads any of them; `save_policy` writes them in the layout
and bytes the JAX package's EvalAgent.save writes, so checkpoints cross
between the packages both ways. `EvalAgent` is a loaded policy as a host
agent (dm_env `step`) with its batched `policy()`, its flax-layout
`params` and `save`.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from putting_dune_torch import device as device_lib
from putting_dune_torch.agents import agent_lib
from putting_dune_torch.agents import msgpack_reader
from putting_dune_torch.agents import ppo
from putting_dune_torch.io import serialization
from putting_dune_torch.utils import profiling

# The JAX package's shipped weights, read in place (never copied).
MODEL_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    'putting_dune_tpu', 'experiments', 'model_weights',
)


def read_flax_params(path: str) -> dict:
  with open(path, 'rb') as f:
    return msgpack_reader.unpackb(f.read())


class MLPPolicy(nn.Module):
  """Vector-observation policy head: a tanh tower, then
  `output_scale * tanh(Dense(action_dim))`. `output_scale` is a float or
  one value per action dim."""

  def __init__(self, obs_dim: int, hidden: Sequence[int] = (256, 256),
               action_dim: int = 2, output_scale=1.0):
    super().__init__()
    self.obs_dim = int(obs_dim)
    # As given (a float or a list), for policy.json.
    self.output_scale_arch = (
        [float(v) for v in output_scale]
        if isinstance(output_scale, (list, tuple)) else float(output_scale))
    widths = [obs_dim, *hidden]
    self.hidden = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
    self.out = nn.Linear(widths[-1], action_dim)
    self.register_buffer(
        'output_scale', torch.as_tensor(output_scale, dtype=torch.float32))

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    x = obs
    for layer in self.hidden:
      x = torch.tanh(layer(x))
    return self.output_scale * torch.tanh(self.out(x))


class ConvPolicy(nn.Module):
  """{image, goal_delta_angstroms} dict-observation policy head: 3x3
  stride-2 'SAME' convolutions and hidden layers with swish, then
  tanh(Dense(action_dim)). Only the flattened size depends on
  `image_size`: any frame of ceil(image_size / 2^L) after L convolutions
  fits."""

  def __init__(self, hidden: Sequence[int] = (256,), action_dim: int = 2,
               features: Sequence[int] = (16, 32, 64), image_size: int = 128):
    super().__init__()
    self.hidden_sizes = tuple(int(h) for h in hidden)
    self.features = tuple(int(f) for f in features)
    self.action_dim = int(action_dim)
    self.convs = nn.ModuleList()
    channels = 1
    for f in self.features:
      self.convs.append(nn.Conv2d(channels, f, 3, stride=2, padding=0))
      channels = f
    size = ppo.conv_output_size(image_size, len(self.features))
    widths = [channels * size * size + 2, *self.hidden_sizes]
    self.hidden = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
    self.out = nn.Linear(widths[-1], action_dim)

  def forward(self, obs) -> torch.Tensor:
    x = torch.cat([ppo.conv_encode(self.convs, obs['image'], F.silu),
                   obs['goal_delta_angstroms']], dim=-1)
    for layer in self.hidden:
      x = F.silu(layer(x))
    return torch.tanh(self.out(x))


def conv_policy_from_flax(params: Mapping[str, Mapping[str, np.ndarray]]
                          ) -> ConvPolicy:
  """Builds a ConvPolicy holding flax ConvPolicy parameters (`Conv_i`,
  then `Dense_0` .. `Dense_n`, the last one the action head); the widths
  and the flattened frame size are read from the kernels."""
  conv_names = ppo.indexed_names(params, 'Conv_')
  dense_names = ppo.indexed_names(params, 'Dense_')
  features = [params[k]['kernel'].shape[-1] for k in conv_names]
  flat = params[dense_names[0]]['kernel'].shape[0] - 2
  size = int(round((flat / features[-1]) ** 0.5))
  model = ConvPolicy(
      hidden=[params[k]['kernel'].shape[-1] for k in dense_names[:-1]],
      action_dim=params[dense_names[-1]]['kernel'].shape[-1],
      features=features, image_size=size * 2 ** len(features))
  for conv, name in zip(model.convs, conv_names):
    ppo.copy_conv_(conv, params[name], name)
  for layer, name in zip([*model.hidden, model.out], dense_names):
    ppo.copy_dense_(layer, params[name], name)
  return model.eval()


def policy_to_flax(model: nn.Module) -> dict:
  """The flax parameter tree of a policy module, in the layout its JAX
  counterpart holds: conv kernels OIHW -> HWIO, Dense (out, in) -> (in,
  out)."""
  if isinstance(model, ppo.ActorCritic):
    return ppo.actor_critic_to_flax(model)
  if isinstance(model, MLPPolicy):
    layers = [*model.hidden, model.out]
    return {f'Dense_{i}': ppo.flax_dense(l) for i, l in enumerate(layers)}
  if isinstance(model, ConvPolicy):
    params = {f'Conv_{i}': ppo.flax_conv(c) for i, c in enumerate(model.convs)}
    for i, layer in enumerate([*model.hidden, model.out]):
      params[f'Dense_{i}'] = ppo.flax_dense(layer)
    return params
  raise ValueError(f'Unsupported policy module {type(model).__name__}')


def _policy_meta(model: nn.Module) -> dict:
  if isinstance(model, MLPPolicy):
    return {'kind': 'mlp', 'arch': {
        'hidden': [l.out_features for l in model.hidden],
        'action_dim': model.out.out_features,
        'output_scale': model.output_scale_arch}}
  if isinstance(model, ConvPolicy):
    return {'kind': 'conv', 'arch': {
        'hidden': list(model.hidden_sizes), 'action_dim': model.action_dim,
        'features': list(model.features)}}
  if isinstance(model, ppo.ActorCritic):
    if not model.takes_images:
      raise ValueError(
          'a vector-observation ActorCritic is saved as its mlp policy '
          '(ppo.as_policy), as the JAX package saves it.')
    return {'kind': 'actor_critic', 'arch': {
        'hidden': list(model.hidden_sizes),
        'conv_features': list(model.conv_features),
        'action_dim': model.action_dim, 'image_size': model.image_size}}
  raise ValueError(f'Unsupported policy module {type(model).__name__}')


def save_policy(model: nn.Module, save_dir: str) -> None:
  """Writes `policy.json` and `policy.ckpt` (flax msgpack bytes) for an
  MLPPolicy ('mlp'), a ConvPolicy ('conv') or an image ActorCritic
  ('actor_critic'); both packages load the directory."""
  meta = _policy_meta(model)
  os.makedirs(save_dir, exist_ok=True)
  with open(os.path.join(save_dir, 'policy.json'), 'w') as f:
    json.dump(meta, f)
  with open(os.path.join(save_dir, 'policy.ckpt'), 'wb') as f:
    f.write(serialization.to_bytes(policy_to_flax(model)))


def load_mlp_params_(model: MLPPolicy,
                     params: Mapping[str, Mapping[str, np.ndarray]]
                     ) -> MLPPolicy:
  """Copies a flax MLPPolicy tree (`Dense_0` .. `Dense_n`, the last one the
  action head) into `model`; raises ValueError where a layer is missing or
  a shape does not fit."""
  layers = [*model.hidden, model.out]
  names = ppo.indexed_names(params, 'Dense_')
  if names != [f'Dense_{i}' for i in range(len(layers))]:
    raise ValueError(f'MLP parameters {sorted(params)} do not fit '
                     f'{len(layers)} layers')
  for layer, name in zip(layers, names):
    ppo.copy_dense_(layer, params[name], name)
  return model


def mlp_from_flax(
    params: Mapping[str, Mapping[str, np.ndarray]], *, output_scale=1.0
) -> MLPPolicy:
  """Builds an MLPPolicy holding flax MLPPolicy parameters; the widths are
  read from the kernels."""
  kernels = [np.asarray(params[k]['kernel'])
             for k in ppo.indexed_names(params, 'Dense_')]
  model = MLPPolicy(
      obs_dim=kernels[0].shape[0],
      hidden=[k.shape[1] for k in kernels[:-1]],
      action_dim=kernels[-1].shape[1],
      output_scale=output_scale,
  )
  return load_mlp_params_(model, params).eval()


def load_policy(load_dir: str, device=None) -> nn.Module:
  """Loads a saved policy directory as a module on `device` (CUDA unless
  asked otherwise; `device.resolve_device`): an ActorCritic for kind
  'actor_critic', an MLPPolicy for 'mlp', a ConvPolicy for 'conv'."""
  with open(os.path.join(load_dir, 'policy.json')) as f:
    meta = json.load(f)
  arch = meta['arch']
  if meta['kind'] not in ('actor_critic', 'mlp', 'conv'):
    raise ValueError(f"Unknown policy kind {meta['kind']!r}")
  params = read_flax_params(os.path.join(load_dir, 'policy.ckpt'))
  if meta['kind'] == 'mlp':
    model = mlp_from_flax(
        params, output_scale=arch.get('output_scale', 1.0))
    if ([layer.out_features for layer in model.hidden] != arch['hidden']
        or model.out.out_features != arch['action_dim']):
      raise ValueError(
          f'{load_dir}: policy.ckpt does not fit the arch in policy.json.')
  elif meta['kind'] == 'conv':
    model = conv_policy_from_flax(params)
    if (list(model.hidden_sizes) != arch['hidden']
        or list(model.features) != arch['features']
        or model.action_dim != arch['action_dim']):
      raise ValueError(
          f'{load_dir}: policy.ckpt does not fit the arch in policy.json.')
  else:
    model = ppo.actor_critic_from_flax(
        params, image_size=arch.get('image_size', 128))
  return model.to(device_lib.resolve_device(device))


def mean_policy(model: nn.Module):
  """A batched policy (gen, obs) -> deterministic action: the mean head
  of an ActorCritic, or the output of an MLPPolicy or a ConvPolicy."""

  def policy(gen, obs):
    del gen
    with profiling.span('policy.step'), torch.no_grad():
      out = model(obs)
    return out[0] if isinstance(out, tuple) else out

  return policy


class TfSavedModelAgent(agent_lib.Agent):
  """A frozen policy exported as a TF SavedModel: `step` feeds the raw
  observation (an array, or a pixel policy's {image, goal_delta_angstroms}
  dict) to the SavedModel's `__call__` and returns the action as a numpy
  array, as the JAX package's TfSavedModelAgent does. The file (an
  `XlaCallModule` export, or a graph of TF ops such as the reference's
  2023 jax2tf policies) is read and run without TensorFlow
  (`io/tf_export.py`) on `device`."""

  def __init__(self, path: str, device=None):
    from putting_dune_torch.io import tf_export

    self._model = tf_export.load_tf_saved_model(path, device)

  def step(self, time_step) -> np.ndarray:
    with torch.no_grad():
      return self._model(time_step.observation).cpu().numpy()

  def set_mode(self, mode: agent_lib.AgentMode) -> None:
    pass


class EvalAgent(agent_lib.Agent):
  """A frozen policy module as a host agent: `step` acts on one dm_env
  timestep, `policy()` is the batched policy for the batched evaluator."""

  def __init__(self, model: nn.Module):
    self.model = model

  @classmethod
  def load(cls, load_dir: str, device=None) -> 'EvalAgent':
    """A saved policy directory (`load_policy`) on `device`."""
    return cls(load_policy(load_dir, device))

  @classmethod
  def from_actor_critic(cls, params, *, hidden, conv_features, action_dim,
                        image_size=128, device=None) -> 'EvalAgent':
    """An image actor-critic policy from flax-layout ActorCritic params
    (the JAX package's `from_actor_critic`), on `device`; raises
    ValueError where the params do not fit the architecture given."""
    model = ppo.actor_critic_from_flax(params, image_size=image_size)
    if (list(model.hidden_sizes) != list(hidden)
        or list(model.conv_features) != list(conv_features)
        or model.action_dim != action_dim):
      raise ValueError(
          f'params do not fit hidden={hidden}, conv_features='
          f'{conv_features}, action_dim={action_dim}')
    return cls(model.to(device_lib.resolve_device(device)))

  @property
  def params(self) -> dict:
    """The frozen policy's parameters as the flax-layout numpy tree of the
    JAX package's `EvalAgent.params` (e.g. to warm-start a run)."""
    return policy_to_flax(self.model)

  def save(self, save_dir: str) -> None:
    """Writes the policy directory (`save_policy`) that both packages'
    `EvalAgent.load` read."""
    save_policy(self.model, save_dir)

  @property
  def device(self) -> torch.device:
    return next(self.model.parameters()).device

  def step(self, time_step) -> np.ndarray:
    obs = time_step.observation
    if isinstance(obs, Mapping):
      obs = {k: torch.as_tensor(np.asarray(v, np.float32),
                                device=self.device)[None]
             for k, v in obs.items()}
    else:
      obs = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None]
    return self.policy()(None, obs)[0].cpu().numpy()

  def set_mode(self, mode: agent_lib.AgentMode) -> None:
    pass

  def policy(self):
    return mean_policy(self.model)
