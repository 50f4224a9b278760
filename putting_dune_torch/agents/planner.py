"""Rate-aware planning controller: per-step beam optimization on the device.

Port of `make_candidate_offsets`, `planner_policy` and `PlannerAgent` of
putting_dune_tpu/agents/planner.py. Every step, for the whole batch, a
dense polar grid of K candidate beam offsets is scored against the rate
law:

    score(c) = sum_i  p_i(c) * v_i,
    p_i(c)   = r_i(c)/R(c) * (1 - exp(-R(c) * dwell)),   R = sum_i r_i
    v_i      = (||g - s|| - ||g - n_i||)  [+ lookahead bonus]

p_i is the probability that the first transition within the dwell moves
the silicon to neighbor i; v_i is that move's progress toward the goal in
angstroms. The multi-dopant planner is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from putting_dune_torch import rates as rates_lib


def make_candidate_offsets(
    num_radii: int = 10,
    num_angles: int = 64,
    min_radius: float = 0.3,
    max_radius: float = 3.2,
) -> np.ndarray:
  """Polar grid of (K, 2) candidate beam offsets from the silicon, in
  angstroms."""
  radii = np.linspace(min_radius, max_radius, num_radii, dtype=np.float32)
  angles = np.linspace(
      0.0, 2.0 * np.pi, num_angles, endpoint=False, dtype=np.float32
  )
  rr, aa = np.meshgrid(radii, angles, indexing='ij')
  return np.stack(
      [rr * np.cos(aa), rr * np.sin(aa)], axis=-1
  ).reshape(-1, 2)


def planner_scores(
    observation: torch.Tensor,
    *,
    rate_fn: rates_lib.RateFunction,
    dwell_seconds: float = 5.0,
    candidates,
    lookahead_discount: float = 0.0,
    dwell_grid_seconds=None,
    image_duration_seconds: float = 2.0,
    dwell_objective: str = 'per_second',
    overshoot_penalty_angstroms: float = 0.71,
) -> torch.Tensor:
  """The planner's score of every candidate: (B, K), or (B, K, D) when a
  dwell grid is given. Arguments as in `planner_policy`."""
  if dwell_objective not in ('per_second', 'per_frame'):
    raise ValueError(
        f"dwell_objective must be 'per_second' or 'per_frame', got"
        f' {dwell_objective!r}'
    )
  device = observation.device
  batch = observation.shape[0]
  si = observation[:, 0:2]
  neighbor_deltas = observation[:, 2:8].reshape(batch, 3, 2)
  goal_delta = observation[:, 8:10]

  cand = torch.as_tensor(candidates, dtype=torch.float32, device=device)
  k = cand.shape[0]

  # Rate evaluation for all B*K (env, candidate) pairs in one call.
  si_flat = si[:, None, :].expand(batch, k, 2).reshape(-1, 2)
  nbr = si[:, None, :] + neighbor_deltas  # (B, 3, 2) absolute positions
  nbr_flat = nbr[:, None, :, :].expand(batch, k, 3, 2).reshape(-1, 3, 2)
  beam_flat = (si[:, None, :] + cand[None, :, :]).reshape(-1, 2)
  r = rate_fn(si_flat, nbr_flat, beam_flat).reshape(batch, k, 3)
  r = torch.clamp(r, min=0.0)

  total = torch.sum(r, dim=-1)  # (B, K)
  frac = torch.where(
      total[..., None] > 0.0,
      r / torch.clamp(total[..., None], min=1e-30),
      torch.zeros_like(r),
  )  # (B, K, 3)

  # Progress toward goal of each one-hop move, angstroms.
  dist_now = torch.linalg.vector_norm(goal_delta, dim=-1)  # (B,)
  dist_next = torch.linalg.vector_norm(
      goal_delta[:, None, :] - neighbor_deltas, dim=-1
  )  # (B, 3)
  value = dist_now[:, None] - dist_next  # (B, 3)

  if lookahead_discount > 0.0:
    # After s -> n_i the new neighbor set is {s, n_i + R(+-120deg)(s - n_i)}
    # (honeycomb geometry), so no rollout is needed.
    back = -neighbor_deltas  # s - n_i, (B, 3, 2)
    cos120 = -0.5
    sin120 = math.sqrt(3.0) / 2.0

    def rot(v, s):
      x, y = v[..., 0], v[..., 1]
      return torch.stack(
          [cos120 * x - s * sin120 * y, s * sin120 * x + cos120 * y], dim=-1
      )

    second = torch.stack([back, rot(back, 1.0), rot(back, -1.0)], dim=2)
    second_abs = neighbor_deltas[:, :, None, :] + second  # (B, 3, 3, 2)
    dist_second = torch.linalg.vector_norm(
        goal_delta[:, None, None, :] - second_abs, dim=-1
    )  # (B, 3, 3)
    bonus = torch.clamp(
        dist_next[..., None] - dist_second, min=0.0
    ).amax(dim=-1)  # (B, 3)
    value = value + lookahead_discount * bonus

  if dwell_grid_seconds is None:
    # P(first transition = i, within dwell) under the exponential
    # waiting-time law the KMC engine samples from.
    p_any = 1.0 - torch.exp(-total * dwell_seconds)  # (B, K)
    return torch.sum(frac * p_any[..., None] * value[:, None, :], dim=-1)

  dwells = torch.as_tensor(dwell_grid_seconds, dtype=torch.float32,
                           device=device)  # (D,)
  p_any = 1.0 - torch.exp(-total[..., None] * dwells[None, None, :])
  expected_progress = (
      torch.sum(frac * value[:, None, :], dim=-1)[..., None] * p_any
  )  # (B, K, D)
  if dwell_objective == 'per_frame':
    # Net progress per action: expected first-transition progress minus
    # the expected cost of extra (post-first) transitions, which for a
    # Poisson(R*T) count is R*T - P(N >= 1).
    extra_hops = total[..., None] * dwells[None, None, :] - p_any
    return expected_progress - overshoot_penalty_angstroms * extra_hops
  return expected_progress / (dwells[None, None, :] + image_duration_seconds)


def planner_policy(
    gen: Optional[torch.Generator],
    observation: torch.Tensor,
    *,
    rate_fn: rates_lib.RateFunction,
    dwell_seconds: float = 5.0,
    candidates,
    lookahead_discount: float = 0.0,
    dwell_grid_seconds=None,
    image_duration_seconds: float = 2.0,
    dwell_objective: str = 'per_second',
    overshoot_penalty_angstroms: float = 0.71,
) -> torch.Tensor:
  """Batched planner policy over 10-dim material-frame features.

  Args:
    gen: unused (the planner is deterministic); kept for the policy API.
    observation: (B, 10) SingleSiliconMaterialFrameFeatures,
      [si_xy, 3 neighbor deltas, goal delta], angstroms.
    rate_fn: the planning model, (si, neighbors, beam) -> (B, 3) rates.
    dwell_seconds: beam dwell per action (must match the adapter) when the
      dwell is fixed.
    candidates: (K, 2) candidate beam offsets from the silicon, angstroms.
    lookahead_discount: weight of the geometric second-step bonus
      (0 disables it).
    dwell_grid_seconds: if set, also optimize the dwell over this (D,)
      grid of seconds; the returned action then has a 3rd dim, the dwell
      as a [0, 1] fraction of [grid_min, grid_max], matching the
      variable-dwell adapters.
    image_duration_seconds: per-action imaging time added to the clock.
    dwell_objective: 'per_second' divides expected progress by dwell +
      image time; 'per_frame' maximizes net progress per action, charging
      expected extra transitions `overshoot_penalty_angstroms` each.
    overshoot_penalty_angstroms: see above ('per_frame' only).

  Returns:
    (B, 2) material-frame actions (beam deltas from the silicon,
    angstroms), or (B, 3) with the dwell fraction appended when
    dwell_grid_seconds is set.
  """
  del gen
  score = planner_scores(
      observation, rate_fn=rate_fn, dwell_seconds=dwell_seconds,
      candidates=candidates, lookahead_discount=lookahead_discount,
      dwell_grid_seconds=dwell_grid_seconds,
      image_duration_seconds=image_duration_seconds,
      dwell_objective=dwell_objective,
      overshoot_penalty_angstroms=overshoot_penalty_angstroms,
  )
  cand = torch.as_tensor(candidates, dtype=torch.float32,
                         device=observation.device)
  if dwell_grid_seconds is None:
    return cand[torch.argmax(score, dim=-1)]
  dwells = torch.as_tensor(dwell_grid_seconds, dtype=torch.float32,
                           device=observation.device)
  best = torch.argmax(score.reshape(score.shape[0], -1), dim=-1)
  best_k, best_d = best // dwells.shape[0], best % dwells.shape[0]
  span = torch.clamp(dwells[-1] - dwells[0], min=1e-9)
  dwell_frac = (dwells[best_d] - dwells[0]) / span
  return torch.cat([cand[best_k], dwell_frac[:, None]], dim=-1)


@dataclasses.dataclass
class PlannerAgent:
  """Registry agent over `planner_policy` (material-frame features +
  RelativeToSiliconMaterialFrameActionAdapter). `policy()` is the batched
  policy for eval_lib.evaluate_batched."""

  rate_fn: rates_lib.RateFunction
  dwell_seconds: float = 5.0
  lookahead_discount: float = 0.0
  num_radii: int = 10
  num_angles: int = 64
  # For variable-dwell adapters: the adapter's exact (min_dwell_seconds,
  # max_dwell_seconds) range; the planner scores a grid over it and emits
  # the 3rd action dim as the matching fraction.
  dwell_range_seconds: Optional[tuple] = None
  num_dwells: int = 8
  image_duration_seconds: float = 2.0
  dwell_objective: str = 'per_second'

  def __post_init__(self):
    self._candidates = make_candidate_offsets(
        num_radii=self.num_radii, num_angles=self.num_angles
    )
    self._dwell_grid = None
    if self.dwell_range_seconds is not None:
      lo, hi = self.dwell_range_seconds
      self._dwell_grid = np.linspace(
          lo, hi, self.num_dwells, dtype=np.float32
      )

  def policy(self):
    return lambda gen, obs: planner_policy(
        gen,
        obs,
        rate_fn=self.rate_fn,
        dwell_seconds=self.dwell_seconds,
        candidates=self._candidates,
        lookahead_discount=self.lookahead_discount,
        dwell_grid_seconds=self._dwell_grid,
        image_duration_seconds=self.image_duration_seconds,
        dwell_objective=self.dwell_objective,
    )
