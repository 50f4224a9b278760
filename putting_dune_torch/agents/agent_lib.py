"""Batched policies: `policy(gen, observation) -> action` on tensors.

Port of the batched policies of putting_dune_tpu/agents/agent_lib.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from putting_dune_torch import geometry

# Beam offset (angstroms, for a neighbor toward +x) the greedy controller
# targets: directly on the neighbor.
DEFAULT_GREEDY_ARGMAX = (1.42, 0.0)


def _batch_of(observation) -> tuple[int, torch.device]:
  leaf = (next(iter(observation.values())) if isinstance(observation, dict)
          else observation)
  return leaf.shape[0], leaf.device


def uniform_random_policy(
    gen: torch.Generator,
    observation,
    *,
    low=-1.0,
    high=1.0,
    action_dim: int = 2,
) -> torch.Tensor:
  """Uniform random actions in [low, high), (B, action_dim)."""
  batch, device = _batch_of(observation)
  low = torch.as_tensor(low, dtype=torch.float32, device=device)
  high = torch.as_tensor(high, dtype=torch.float32, device=device)
  u = torch.rand((batch, action_dim), generator=gen, device=device)
  return u * (high - low) + low


def greedy_policy(
    gen: Optional[torch.Generator],
    observation: torch.Tensor,
    *,
    argmax: tuple[float, float] = DEFAULT_GREEDY_ARGMAX,
) -> torch.Tensor:
  """Greedy controller over 10-dim material-frame features.

  Picks the neighbor whose delta best matches the goal delta and places
  the beam at `argmax` rotated to that neighbor's angle. Returns (B, 2)
  beam deltas from the silicon, angstroms. (The JAX package's beam offset
  and position noise options are not ported; no experiment sets them.)
  """
  del gen
  batch = observation.shape[0]
  neighbor_deltas = observation[:, 2:8].reshape(batch, 3, 2)
  goal_delta = observation[:, 8:10]
  scores = torch.linalg.vector_norm(
      neighbor_deltas - goal_delta[:, None, :], dim=-1)
  best = torch.argmin(scores, dim=-1)
  angles = geometry.get_angles(neighbor_deltas)
  angle = torch.gather(angles, 1, best[:, None])[:, 0]
  beam = torch.tensor(argmax, dtype=torch.float32,
                      device=observation.device).expand(batch, 2)
  return geometry.rotate_coordinates(beam, angle)
