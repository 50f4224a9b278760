"""The pixel policy: the reference actor-critic, with the shipped weights
read by its own reader, on the observation the policy was handed at each
recorded loop step, against the action it returned.

Number: `action_gap`, the largest |program - reference| over every frame
and action dimension (the actions lie in [-1, 1])."""

from __future__ import annotations

import functools
import os

import torch

from benchmark.lib import cells
from benchmark.reference import flax_msgpack
from benchmark.reference import networks
from benchmark.reference import precision as precision_lib


@functools.lru_cache(maxsize=2)
def _params(path: str, device: str):
  return networks.tensors(flax_msgpack.load(os.path.join(cells.ROOT, path)),
                          torch.device(device))


def compare(samples, config, traffic, control: bool) -> dict:
  worst = 0.0
  for sample in samples:
    if 'policy_input' not in sample:
      continue  # the reset: no action taken
    obs, got = sample['policy_input'], sample['action']
    params = _params(config['weights'], str(got.device))
    mean = functools.partial(networks.actor_critic_mean, params,
                             obs['image'], obs['goal_delta_angstroms'])
    ref = mean()
    if control:
      got = mean(precision=precision_lib.LOWER[config['precision']['policy']])
    if got.shape != ref.shape:
      return {'action_gap': 2.0}
    gap = torch.abs(got - ref)
    gap = torch.where(torch.isfinite(got), gap, torch.full_like(gap, 2.0))
    worst = max(worst, float(gap.max()))
  return {'action_gap': worst}
