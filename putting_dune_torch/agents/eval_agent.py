"""Frozen-policy loading (port of putting_dune_tpu/agents/eval_agent.py).

A checkpoint directory holds `policy.json` (kind + architecture) and
`policy.ckpt` (flax msgpack parameters). The shipped weights under
putting_dune_tpu/experiments/model_weights/ are read in place, as data.
Only the 'actor_critic' kind (the mean head of a PPO ActorCritic) is
ported; 'mlp' and 'conv' policies wait.
"""

from __future__ import annotations

import json
import os

import torch

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


def load_policy(load_dir: str, device='cpu') -> ppo.ActorCritic:
  """Loads a saved policy directory as an ActorCritic on `device`."""
  with open(os.path.join(load_dir, 'policy.json')) as f:
    meta = json.load(f)
  if meta['kind'] != 'actor_critic':
    raise NotImplementedError(
        f"policy kind {meta['kind']!r} is not ported to putting_dune_torch.")
  params = read_flax_params(os.path.join(load_dir, 'policy.ckpt'))
  model = ppo.actor_critic_from_flax(
      params, image_size=meta['arch'].get('image_size', 128))
  return model.to(device)


def mean_policy(model: ppo.ActorCritic):
  """A batched policy (gen, obs) -> deterministic mean action."""

  def policy(gen, obs):
    del gen
    with torch.no_grad():
      mean, _, _ = model(obs)
    return mean

  return policy
