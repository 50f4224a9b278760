"""Goal sampling, reward and termination, batched.

Port of putting_dune_tpu/env/goals.py.
"""

from __future__ import annotations

import dataclasses

import torch

from putting_dune_torch import constants
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import structures

# Goals are lattice atoms within this material-frame distance ring around
# the silicon.
GOAL_RANGE_ANGSTROMS = (0.1, 50.0)
# Steps-at-goal needed to terminate.
REQUIRED_CONSECUTIVE_GOAL_STEPS = 1


@dataclasses.dataclass
class GoalState:
  """position_material (B, 2) angstroms; consecutive_goal_steps (B,)."""

  position_material: torch.Tensor
  consecutive_goal_steps: torch.Tensor


@dataclasses.dataclass
class GoalReturn:
  reward: torch.Tensor
  is_terminal: torch.Tensor
  is_truncated: torch.Tensor


def sample_goal(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    material: structures.MaterialState,
    fov: structures.FieldOfView,
) -> GoalState:
  """Samples a goal atom uniformly among the atoms inside the FOV whose
  distance from the silicon lies in GOAL_RANGE_ANGSTROMS.

  The uniform choice is the argmax of iid uniforms over the valid atoms
  (the JAX package uses Gumbel-max; both are exactly uniform).
  """
  world = lattice_lib.world_positions(lattice, material.offset, material.theta)
  si_pos = lattice_lib.site_position(
      lattice, material.si_index, material.offset, material.theta
  )
  in_fov = torch.all(
      (world >= fov.lower_left[..., None, :])
      & (world <= fov.upper_right[..., None, :]),
      dim=-1,
  )
  dist = torch.linalg.vector_norm(world - si_pos[..., None, :], dim=-1)
  lo, hi = GOAL_RANGE_ANGSTROMS
  valid = in_fov & (dist > lo) & (dist < hi)
  u = torch.rand(valid.shape, generator=gen, device=world.device)
  goal_idx = torch.argmax(torch.where(valid, u, torch.full_like(u, -1.0)),
                          dim=-1)
  goal_pos = torch.gather(
      world, 1, goal_idx[:, None, None].expand(-1, 1, 2)
  )[:, 0, :]
  return GoalState(
      position_material=goal_pos,
      consecutive_goal_steps=torch.zeros_like(material.si_index,
                                              dtype=torch.int32),
  )


def reward_and_terminal(
    goal: GoalState,
    si_position_material: torch.Tensor,
    elapsed_seconds: torch.Tensor,
) -> tuple[GoalState, GoalReturn]:
  """Terminal once the silicon is within 0.5 bond lengths of the goal;
  the terminal reward is gamma ** elapsed_seconds, else 0."""
  goal_radius = constants.CARBON_BOND_DISTANCE_ANGSTROMS * 0.5
  goal_distance = torch.linalg.vector_norm(
      si_position_material - goal.position_material, dim=-1
  )
  at_goal = goal_distance < goal_radius
  consecutive = torch.where(
      at_goal, goal.consecutive_goal_steps + 1,
      torch.zeros_like(goal.consecutive_goal_steps),
  )
  is_terminal = consecutive >= REQUIRED_CONSECUTIVE_GOAL_STEPS
  reward = torch.where(
      is_terminal,
      torch.pow(constants.GAMMA_PER_SECOND, elapsed_seconds),
      torch.zeros_like(elapsed_seconds),
  )
  new_goal = GoalState(goal.position_material, consecutive)
  return new_goal, GoalReturn(reward, is_terminal,
                              torch.zeros_like(is_terminal))
