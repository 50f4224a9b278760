"""Frozen-policy loading (port of putting_dune_tpu/agents/eval_agent.py).

A checkpoint directory holds `policy.json` (kind + architecture) and
`policy.ckpt` (flax msgpack parameters). The shipped weights under
putting_dune_tpu/experiments/model_weights/ are read in place, as data.
Two kinds are ported: 'actor_critic' (the mean head of a PPO ActorCritic,
for image policies) and 'mlp' (the vector-observation tanh tower of the
multi-dopant checkpoints); 'conv' policies wait.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from putting_dune_torch import device as device_lib
from putting_dune_torch.agents import msgpack_reader
from putting_dune_torch.agents import ppo

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


def mlp_from_flax(
    params: Mapping[str, Mapping[str, np.ndarray]], *, output_scale=1.0
) -> MLPPolicy:
  """Builds an MLPPolicy holding flax MLPPolicy parameters (`Dense_0` ..
  `Dense_n`, the last one the action head). Dense kernels go (in, out) ->
  (out, in); the widths are read from the kernels."""
  names = sorted(params, key=lambda k: int(k.split('_')[1]))
  kernels = [np.asarray(params[k]['kernel']) for k in names]
  model = MLPPolicy(
      obs_dim=kernels[0].shape[0],
      hidden=[k.shape[1] for k in kernels[:-1]],
      action_dim=kernels[-1].shape[1],
      output_scale=output_scale,
  )
  state = {}
  for i, name in enumerate(names):
    prefix = f'hidden.{i}' if i < len(names) - 1 else 'out'
    state[f'{prefix}.weight'] = torch.from_numpy(
        np.ascontiguousarray(kernels[i].T, dtype=np.float32))
    state[f'{prefix}.bias'] = torch.from_numpy(
        np.ascontiguousarray(params[name]['bias'], dtype=np.float32))
  model.load_state_dict(state, strict=False)  # output_scale is a buffer
  return model.eval()


def load_policy(load_dir: str, device=None) -> nn.Module:
  """Loads a saved policy directory as a module on `device` (CUDA unless
  asked otherwise; `device.resolve_device`): an ActorCritic for kind
  'actor_critic', an MLPPolicy for kind 'mlp'."""
  with open(os.path.join(load_dir, 'policy.json')) as f:
    meta = json.load(f)
  arch = meta['arch']
  if meta['kind'] not in ('actor_critic', 'mlp'):
    raise NotImplementedError(
        f"policy kind {meta['kind']!r} is not ported to putting_dune_torch.")
  params = read_flax_params(os.path.join(load_dir, 'policy.ckpt'))
  if meta['kind'] == 'mlp':
    model = mlp_from_flax(
        params, output_scale=arch.get('output_scale', 1.0))
    if ([layer.out_features for layer in model.hidden] != arch['hidden']
        or model.out.out_features != arch['action_dim']):
      raise ValueError(
          f'{load_dir}: policy.ckpt does not fit the arch in policy.json.')
  else:
    model = ppo.actor_critic_from_flax(
        params, image_size=arch.get('image_size', 128))
  return model.to(device_lib.resolve_device(device))


def mean_policy(model: nn.Module):
  """A batched policy (gen, obs) -> deterministic action: the mean head
  of an ActorCritic, or the output of an MLPPolicy."""

  def policy(gen, obs):
    del gen
    with torch.no_grad():
      out = model(obs)
    return out[0] if isinstance(out, tuple) else out

  return policy
