"""One env step's transition in plain PyTorch: the action to the beam, the
KMC's hops under the rate law, the field of view's recentering, the
simulated seconds, the goal, reward and episode end; and the batched
evaluator's accounting of each episode's actions.

The KMC replays the uniforms the program drew (a waiting time and a
choice a round); everything else is recomputed from the state the step
started from. The laws are the simulator's:

- the beam lands at silicon + action x max distance (microscope frame,
  the action clipped to [-1, 1], the position to [0, 1]), less the drift;
- a round's waiting time is -log1p(-u0) / total rate (at most 3600 s);
  the hop fires when the dwell's elapsed time plus it is within the
  dwell; the successor is the first neighbour whose cumulative rate
  reaches u1 x total; rounds go on while a lane's time is under the
  dwell;
- a step takes dwell + one image; if the observed silicon left the
  [0.25, 0.75]^2 safe area the field of view recenters on it (the same
  width) and a second image is charged;
- the episode ends at the goal (the silicon within half a bond of it;
  reward gamma ** seconds, discount 0) or at the step limit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import precision as precision_lib
from benchmark.reference import render

GAMMA_PER_SECOND = 0.9967
MAX_WAITING_SECONDS = 3600.0
GOAL_RADIUS = 0.5 * render.BOND_ANGSTROMS
FIRST, MID, LAST = 0, 1, 2


@functools.lru_cache(maxsize=4)
def neighbor_table(num_cols: int) -> np.ndarray:
  """(N, 3) the three nearest sites of each site, nearest first, ties by
  site order (exact float64 distances)."""
  pos = render.graphene_positions_f64(num_cols)
  table = np.empty((pos.shape[0], 3), np.int64)
  for lo in range(0, pos.shape[0], 512):
    hi = min(lo + 512, pos.shape[0])
    d2 = np.sum((pos[lo:hi, None, :] - pos[None, :, :]) ** 2, axis=-1)
    d2[np.arange(hi - lo), np.arange(lo, hi)] = np.inf
    table[lo:hi] = np.argsort(d2, axis=1, kind='stable')[:, :3]
  return table


def _world(canon, site, offset, theta):
  """World position of `site` (B,) or (B, K) under each row's pose."""
  p = canon[site] + (offset if site.dim() == 1 else offset[:, None, :])
  t = theta if site.dim() == 1 else theta[:, None]
  c, s = torch.cos(t), torch.sin(t)
  return torch.stack([p[..., 0] * c - p[..., 1] * s,
                      p[..., 0] * s + p[..., 1] * c], dim=-1)


def step(before: dict, action: torch.Tensor, uniforms, *, law, env: dict,
         precision: str = 'float32') -> dict:
  """The step from `before` under `action`, the KMC drawing `uniforms`
  ((B, 2) a round, in order). Returns the beam (B, 2, material frame),
  the silicon's site, the field of view, the step's seconds, step type
  and reward, and `rounds_off` (B,) bool where the draws ran out or were
  left over."""
  r = lambda t: precision_lib.round_to(t, precision)  # noqa: E731
  dev = before['offset'].device
  num_cols = int(env['grid_columns'])
  canon = torch.from_numpy(render.graphene_positions(num_cols)).to(dev)
  table = torch.from_numpy(neighbor_table(num_cols)).to(dev)
  offset, theta = before['offset'], before['theta']
  ll, ur, drift = before['lower_left'], before['upper_right'], before['drift']
  extent = r(ur - ll)
  batch = offset.shape[0]

  si_micro = r(r(_world(canon, before['si_index'], offset, theta) + drift - ll)
               / extent)
  delta = torch.clamp(action[:, :2], -1.0, 1.0)
  aim = torch.clamp(
      si_micro + delta * r(float(env['max_distance_angstroms']) / extent),
      0.0, 1.0)
  beam = r(r(aim * extent) + ll - drift)

  dwell = torch.full((batch,), float(env['dwell_seconds']), device=dev)
  si = before['si_index'].to(torch.int64)
  elapsed = torch.zeros((batch,), device=dev)
  active = dwell > 0.0
  rounds_off = torch.zeros((batch,), dtype=torch.bool, device=dev)
  for u in uniforms:
    if not bool(active.any()):
      rounds_off |= True  # the program drew for a round it need not run
      break
    nbr = table[si]
    rates = law(r(_world(canon, nbr, offset, theta)), beam, precision)
    cum = torch.cumsum(rates, dim=-1)
    total = cum[:, -1]
    dt = torch.clamp(-torch.log1p(-u[:, 0]) / total, max=MAX_WAITING_SECONDS)
    new_elapsed = elapsed + dt
    fired = active & (new_elapsed <= dwell)
    choice = torch.sum((u[:, 1:] * total[:, None]) >= cum[:, :2], dim=-1)
    si = torch.where(fired, torch.gather(nbr, 1, choice[:, None])[:, 0], si)
    elapsed = torch.where(active, new_elapsed, elapsed)
    active = active & (new_elapsed < dwell)
  rounds_off |= active  # lanes still within the dwell when draws ran out

  image = float(env['image_duration_seconds'])
  si_world = _world(canon, si, offset, theta)
  observed = si_world + drift
  micro = (observed - ll) / extent
  outside = torch.any((micro < 0.25) | (micro > 0.75), dim=-1)
  half = extent[:, :1] / 2.0
  lower_left = torch.where(outside[:, None], observed - half, ll)
  upper_right = torch.where(outside[:, None], observed + half, ur)
  seconds = dwell + image + torch.where(outside, image, 0.0)

  at_goal = torch.linalg.vector_norm(si_world - before['goal'],
                                     dim=-1) < GOAL_RADIUS
  terminal = torch.where(at_goal, before['goal_steps'] + 1, 0) >= 1
  reward = torch.where(terminal, torch.pow(GAMMA_PER_SECOND, seconds), 0.0)
  truncated = (before['step_count'] + 1 >= int(env['step_limit'])) & ~terminal
  step_type = torch.where(terminal | truncated, LAST, MID)
  return {'beam': beam, 'si_index': si, 'lower_left': lower_left,
          'upper_right': upper_right, 'elapsed_seconds': seconds,
          'step_type': step_type, 'reward': reward, 'rounds_off': rounds_off}


def episode_actions(reset_elapsed, steps, walls, *, chunk_steps: int,
                    timeout_seconds: float, precision: str = 'float32'):
  """Each episode's actions and whether it reached its goal, as the
  batched evaluator counts them: a step counts while the episode is live;
  it ends at its first LAST (reached where the discount is 0), at a
  FIRST, or once its simulated seconds plus the wall clock read at the
  start of the step's chunk pass the timeout.

  `steps` is each loop step's (step type, discount, seconds); `walls` the
  wall clock of each chunk; the seconds are summed in `precision`.
  Returns (actions (B,) int64, reached (B,))."""
  live = torch.ones_like(reset_elapsed, dtype=torch.bool)
  actions = torch.zeros_like(reset_elapsed, dtype=torch.int64)
  reached = torch.zeros_like(live)
  r = lambda t: precision_lib.round_to(t, precision)  # noqa: E731
  seconds = r(reset_elapsed.clone())
  for t, (step_type, discount, elapsed) in enumerate(steps):
    actions += live.to(torch.int64)
    seconds = r(seconds + torch.where(live, elapsed, 0.0))
    terminal = live & (step_type == LAST)
    reached |= terminal & (discount == 0.0)
    ended = terminal | (step_type == FIRST)
    ended |= seconds + walls[t // chunk_steps] > timeout_seconds
    live = live & ~ended
  return actions, reached
