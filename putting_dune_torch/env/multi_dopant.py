"""Multi-dopant batched environment.

Port of putting_dune_tpu/env/multi_dopant.py: D dopants per environment on
top of kmc.apply_control_multi (one exponential waiting time from the
summed rate, one (dopant, neighbor) move per round, moves onto occupied
sites masked out).

There is still one electron beam, so the action stays a single (2,) beam
position. Each dopant has its own goal atom; the episode terminates when
every dopant has sat within half a bond of its goal for one step, with
terminal reward gamma**elapsed. Observations are per-dopant (position,
goal delta) pairs, flattened: (D * 4,) in the material frame.

    state, ts = env.reset(gen)
    state, ts = env.step(state, action, gen)

Environments whose previous step ended the episode get a fresh FIRST
timestep inside step(); the fresh batch is only built on steps where some
environment needs it, and the observation (and so the STEM frame) is
computed once, from the selected state.

Instrument drift (`drift_per_frame_angstroms = d > 0`) follows
simulator.py: each step adds a U(-d, d) increment per axis to the
cumulative drift, drawn ahead of the KMC (nothing is drawn when d = 0); the
beam aims at the dopant observed in the last frame and lands at -drift;
observations report the drifted world (dopants at true + drift, the frame
rendered through the believed FOV shifted by -drift) while goals are
judged in the true frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import kmc
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch import structures
from putting_dune_torch.env import action_adapters
from putting_dune_torch.env import env as env_lib
from putting_dune_torch.env import features as features_lib
from putting_dune_torch.env import goals as goals_lib
from putting_dune_torch.imaging import params as imaging_params
from putting_dune_torch.imaging import render as imaging_render
from putting_dune_torch.utils import profiling

_ACTION_MODES = ('relative', 'absolute')
_OBSERVATION_MODES = ('vector', 'vector_neighbors', 'image')
_ANCHOR_ORDERS = ('index', 'position')


@dataclasses.dataclass
class MultiDopantState:
  """Batched state: pose + (B, D) dopant sites + per-dopant goals."""

  offset: torch.Tensor  # (B, 2)
  theta: torch.Tensor  # (B,)
  si_indices: torch.Tensor  # (B, D) int64
  fov_lower: torch.Tensor  # (B, 2)
  fov_upper: torch.Tensor  # (B, 2)
  goals: torch.Tensor  # (B, D, 2) material frame
  consecutive: torch.Tensor  # (B, D) int32 consecutive steps at goal
  latched: torch.Tensor  # (B, D) bool, dopant has completed its goal
  steps: torch.Tensor  # (B,) int32
  needs_reset: torch.Tensor  # (B,) bool
  # (B,) int32: steps this episode where the KMC max_events cap cut the
  # dwell short. Always 0 under sane rate functions.
  kmc_truncation_count: torch.Tensor
  imaging: structures.ImagingParams  # per-episode render randomization
  # (B, 2) cumulative instrument drift, material-frame angstroms; None,
  # the JAX package's default, becomes zeros.
  drift: Optional[torch.Tensor] = None

  def __post_init__(self):
    if self.drift is None:
      self.drift = torch.zeros_like(self.offset)


def _initial_sites(lattice: lattice_lib.Lattice, num_dopants: int
                   ) -> torch.Tensor:
  """D well-separated canonical sites: the nearest lattice sites to
  anchors on a ring of radius 2 bonds * (D - 1) around the lattice center,
  made distinct by sequential masking. (D,) int64."""
  device = lattice.device
  angles = (2.0 * math.pi * torch.arange(num_dopants, dtype=torch.float32,
                                         device=device)
            / max(num_dopants, 1))
  radius = 2.0 * constants.CARBON_BOND_DISTANCE_ANGSTROMS * max(
      num_dopants - 1, 1)
  anchors = radius * torch.stack(
      [torch.cos(angles), torch.sin(angles)], dim=-1)  # (D, 2)
  taken = torch.zeros((lattice.num_atoms,), dtype=torch.bool, device=device)
  sites = []
  for d in range(num_dopants):
    dist = torch.linalg.vector_norm(lattice.positions - anchors[d], dim=-1)
    dist = torch.where(taken, torch.full_like(dist, math.inf), dist)
    site = torch.argmin(dist)
    taken[site] = True
    sites.append(site)
  return torch.stack(sites)


@dataclasses.dataclass
class MultiDopantEnv:
  """Batched D-dopant goal-reaching environment.

  Action: (B, 2) in [-1, 1]^2. Observation: (B, D * 4) = per dopant
  [x, y, goal_dx, goal_dy] (material frame, angstroms), or see
  `observation_mode`.

  Attributes:
    lattice: static lattice (moved to `device` if it lives elsewhere).
    rate_fn: batched KMC rate function.
    action_mode: 'relative': the action is a beam offset from the first
      unlatched dopant in units of max_distance_angstroms; 'absolute': the
      action maps onto the whole FOV.
    observation_mode: 'vector' (B, D*4); 'vector_neighbors' adds the
      anchor dopant's 3 neighbor deltas, (B, D*4 + 6); 'image' is a dict
      {'image' (B, S, S, 1), 'goal_delta_angstroms' (B, D*2)} (latched
      dopants read zero delta).
    anchor_order: 'index': the anchor is the first unlatched dopant by
      internal index; 'position': first unlatched in lexicographic (x, y)
      material-position order, and observations list dopants in that
      order, which an agent can reproduce from pixels alone.
    include_fov: expose the believed FOV in image observations.
    max_kmc_events_per_step: per-env cap on KMC events per step.
    device: 'cuda' by default; raises if CUDA is absent unless 'cpu'.
  """

  lattice: lattice_lib.Lattice
  rate_fn: rates_lib.RateFunction
  batch_size: int = 64
  num_dopants: int = 2
  dwell_seconds: float = 1.5
  image_duration_seconds: float = 2.0
  fov_width: float = 25.0
  step_limit: int = 600
  sticky_goals: bool = True
  action_mode: str = 'relative'
  max_distance_angstroms: float = (
      2.0 * constants.CARBON_BOND_DISTANCE_ANGSTROMS)
  observation_mode: str = 'vector'
  anchor_order: str = 'index'
  image_size: int = 128
  window_capacity: int = 512
  noisy_images: bool = False
  drift_per_frame_angstroms: float = 0.0
  include_fov: bool = False
  max_kmc_events_per_step: Optional[int] = 10_000
  device: Any = None

  def __post_init__(self):
    self.device = device_lib.resolve_device(self.device)
    if self.lattice.device != self.device:
      self.lattice = lattice_lib.Lattice(
          self.lattice.positions.to(self.device),
          self.lattice.neighbors.to(self.device),
      )
    for name, value, allowed in (
        ('action_mode', self.action_mode, _ACTION_MODES),
        ('observation_mode', self.observation_mode, _OBSERVATION_MODES),
        ('anchor_order', self.anchor_order, _ANCHOR_ORDERS)):
      if value not in allowed:
        raise ValueError(f'{name} must be one of {allowed}, got {value!r}.')

  # ---------------------------------------------------------------- specs

  def observation_size(self) -> int:
    if self.observation_mode == 'vector_neighbors':
      return self.num_dopants * 4 + 6
    return self.num_dopants * 4

  def action_spec(self) -> action_adapters.ActionSpec:
    return action_adapters.ActionSpec(shape=(2,), minimum=-1.0, maximum=1.0)

  def observation_spec(self):
    if self.observation_mode == 'image':
      spec = {
          'image': features_lib.FeatureSpec(
              shape=(self.image_size, self.image_size, 1)),
          'goal_delta_angstroms': features_lib.FeatureSpec(
              shape=(self.num_dopants * 2,)),
      }
      if self.include_fov:
        spec['fov_lower_left'] = features_lib.FeatureSpec(shape=(2,))
        spec['fov_upper_right'] = features_lib.FeatureSpec(shape=(2,))
      return spec
    return features_lib.FeatureSpec(shape=(self.observation_size(),))

  def shaping_distance(self, obs) -> torch.Tensor:
    """Potential distance for reward shaping: the sum of per-dopant goal
    distances (latched dopants contribute 0)."""
    if isinstance(obs, dict):
      delta = obs['goal_delta_angstroms']
      per = delta.reshape(delta.shape[0], self.num_dopants, 2)
    else:
      per = obs[:, : self.num_dopants * 4].reshape(
          obs.shape[0], self.num_dopants, 4)[..., 2:4]
    return torch.sum(torch.linalg.vector_norm(per, dim=-1), dim=-1)

  # ------------------------------------------------------------- plumbing

  def _si_positions(self, state: MultiDopantState) -> torch.Tensor:
    return lattice_lib.site_position(
        self.lattice, state.si_indices, state.offset, state.theta
    )  # (B, D, 2)

  def _fov(self, state: MultiDopantState) -> structures.FieldOfView:
    return structures.FieldOfView(state.fov_lower, state.fov_upper)

  def _atom_window(
      self,
      state: MultiDopantState,
      fov: Optional[structures.FieldOfView] = None,
  ) -> structures.AtomWindow:
    """Fixed-capacity FOV crop with D silicon dopants, in-view atoms in
    ascending lattice order; is_si is membership in the (B, D) dopant
    set."""
    if fov is None:
      fov = self._fov(state)
    fov_lower, fov_upper = fov.lower_left, fov.upper_right
    world = lattice_lib.world_positions(
        self.lattice, state.offset, state.theta)  # (B, N, 2)
    in_bounds = torch.all(
        (world >= fov_lower[:, None, :]) & (world <= fov_upper[:, None, :]),
        dim=-1,
    )
    n = self.lattice.num_atoms
    capacity = min(self.window_capacity, n)
    order = torch.arange(n, device=world.device)
    # In-bounds scores n - index are distinct, so top-k keeps them in
    # ascending lattice order whatever it does with the -1 ties.
    score = torch.where(in_bounds, n - order, torch.full_like(order, -1))
    top_scores, indices = torch.topk(score, capacity, dim=-1, sorted=True)
    mask = top_scores > 0

    positions_material = torch.gather(
        world, 1, indices[..., None].expand(-1, -1, 2))
    extent = fov_upper - fov_lower
    positions = (
        positions_material - fov_lower[:, None, :]) / extent[:, None, :]
    positions = torch.where(mask[..., None], positions,
                            torch.zeros_like(positions))

    is_si = torch.any(
        indices[..., None] == state.si_indices[:, None, :], dim=-1)
    atomic_numbers = torch.where(
        mask, torch.where(is_si, constants.SILICON, constants.CARBON), 0
    ).to(torch.int32)
    return structures.AtomWindow(
        positions=positions,
        atomic_numbers=atomic_numbers,
        mask=mask,
        si_slot=torch.full((self.batch_size,), -1, dtype=torch.int64,
                           device=world.device),
    )

  def _position_key(self, si: torch.Tensor) -> torch.Tensor:
    """(B, D) lexicographic (x, y) sort key over dopant positions. 4096
    dwarfs the lattice extent (~110 A at 50 columns), so x dominates."""
    return si[..., 0] * 4096.0 + si[..., 1]

  def _anchor_index(self, state: MultiDopantState, si: torch.Tensor
                    ) -> torch.Tensor:
    """(B,) index of the dopant 'relative' actions address: the first
    unlatched dopant, by internal index or by lexicographic position."""
    unlatched = ~state.latched
    if self.anchor_order == 'position':
      key = self._position_key(si)
      key = torch.where(unlatched, key, torch.full_like(key, math.inf))
      return torch.argmin(key, dim=-1)
    return torch.argmax(unlatched.to(torch.int32), dim=-1)

  def _observation(self, state: MultiDopantState,
                   gen: Optional[torch.Generator] = None):
    si_raw = self._si_positions(state)
    # The instrument observes the drifted world: the recorded goals
    # (believed frame, calibrated at reset) go stale by the drift.
    si_obs = si_raw + state.drift[:, None, :]
    si, delta = si_obs, state.goals - si_obs
    if self.sticky_goals:
      # Latched goals read as zero delta.
      delta = torch.where(state.latched[..., None],
                          torch.zeros_like(delta), delta)
    if self.anchor_order == 'position':
      order = torch.argsort(self._position_key(si), dim=-1, stable=True)
      order = order[..., None].expand(-1, -1, 2)
      si = torch.gather(si, 1, order)
      delta = torch.gather(delta, 1, order)
    b = self.batch_size
    if self.observation_mode == 'image':
      if gen is None:
        raise ValueError('image observations require a generator')
      fov = self._fov(state)
      render_fov = fov.shift(-state.drift)
      with profiling.span('render.atom_window'):
        window = self._atom_window(state, fov=render_fov)
      image = imaging_render.render_stem_image(
          gen, window, render_fov, state.imaging, image_size=self.image_size)
      obs = {
          'image': image[..., None],
          'goal_delta_angstroms': delta.reshape(b, -1),
      }
      if self.include_fov:
        obs['fov_lower_left'] = fov.lower_left.to(torch.float32)
        obs['fov_upper_right'] = fov.upper_right.to(torch.float32)
      return obs
    vector = torch.cat([si, delta], dim=-1).reshape(b, -1)
    if self.observation_mode == 'vector_neighbors':
      rows = torch.arange(b, device=vector.device)
      pick_d = self._anchor_index(state, si_raw)  # (B,)
      anchor_site = state.si_indices[rows, pick_d]  # (B,)
      nbr_idx = self.lattice.neighbors[anchor_site]  # (B, 3)
      nbr_pos = lattice_lib.site_position(
          self.lattice, nbr_idx, state.offset, state.theta)  # (B, 3, 2)
      anchor_pos = si_raw[rows, pick_d]  # (B, 2)
      nbr_deltas = nbr_pos - anchor_pos[:, None, :]
      vector = torch.cat([vector, nbr_deltas.reshape(b, 6)], dim=-1)
    return vector

  # ---------------------------------------------------------------- reset

  def _fresh_state(self, gen: torch.Generator) -> MultiDopantState:
    b, d = self.batch_size, self.num_dopants
    dev = self.device

    def uniform(shape, lo, hi):
      return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    offset = uniform((b, 2), -1.0, 1.0) * (
        constants.CARBON_BOND_DISTANCE_ANGSTROMS)
    theta = uniform((b,), 0.0, 2.0 * math.pi)
    sites = _initial_sites(self.lattice, d)[None, :].expand(b, d).contiguous()
    state = MultiDopantState(
        offset=offset,
        theta=theta,
        si_indices=sites,
        fov_lower=torch.zeros((b, 2), device=dev) - self.fov_width / 2,
        fov_upper=torch.zeros((b, 2), device=dev) + self.fov_width / 2,
        goals=torch.zeros((b, d, 2), device=dev),
        consecutive=torch.zeros((b, d), dtype=torch.int32, device=dev),
        latched=torch.zeros((b, d), dtype=torch.bool, device=dev),
        steps=torch.zeros((b,), dtype=torch.int32, device=dev),
        needs_reset=torch.zeros((b,), dtype=torch.bool, device=dev),
        kmc_truncation_count=torch.zeros((b,), dtype=torch.int32,
                                         device=dev),
        imaging=imaging_params.sample_imaging_params(
            gen, b, device=dev, noisy=self.noisy_images),
        drift=torch.zeros((b, 2), device=dev),
    )
    si = self._si_positions(state)  # (B, D, 2)

    # Per-dopant goal: a lattice atom within the goal annulus of that
    # dopant and inside the FOV, chosen one dopant after the other with
    # the atoms already taken masked out, so that no two dopants share a
    # goal atom. The uniform choice is the argmax of iid uniforms over the
    # valid atoms (the JAX package uses Gumbel-max; both are uniform).
    world = lattice_lib.world_positions(self.lattice, offset, theta)
    lo, hi = goals_lib.GOAL_RANGE_ANGSTROMS
    in_fov = torch.all(
        (world >= state.fov_lower[:, None, :])
        & (world <= state.fov_upper[:, None, :]),
        dim=-1,
    )  # (B, N)
    dist = torch.linalg.vector_norm(
        world[:, None, :, :] - si[:, :, None, :], dim=-1)  # (B, D, N)
    valid = in_fov[:, None, :] & (dist >= lo) & (dist <= hi)
    rows = torch.arange(b, device=dev)
    taken = torch.zeros_like(in_fov)
    choices = []
    for dd in range(d):
      u = torch.rand(in_fov.shape, generator=gen, device=dev)
      score = torch.where(valid[:, dd] & ~taken, u, torch.full_like(u, -1.0))
      choice_d = torch.argmax(score, dim=-1)  # (B,)
      taken[rows, choice_d] = True
      choices.append(choice_d)
    choice = torch.stack(choices, dim=-1)  # (B, D)
    state.goals = torch.gather(world, 1, choice[..., None].expand(-1, -1, 2))
    return state

  def reset(self, gen: torch.Generator
            ) -> tuple[MultiDopantState, env_lib.TimeStep]:
    b, dev = self.batch_size, self.device
    with profiling.span('env_step.step'):
      state = self._fresh_state(gen)
      ts = env_lib.TimeStep(
          step_type=torch.full((b,), env_lib.FIRST, dtype=torch.int32,
                               device=dev),
          reward=torch.zeros((b,), device=dev),
          discount=torch.ones((b,), device=dev),
          observation=self._observation(state, gen),
          elapsed_seconds=torch.zeros((b,), device=dev),
      )
      return state, ts

  # ----------------------------------------------------------------- step

  def step(self, state: MultiDopantState, action: torch.Tensor,
           gen: torch.Generator
           ) -> tuple[MultiDopantState, env_lib.TimeStep]:
    """Advances every environment one step (auto-resetting finished ones)."""
    with profiling.span('env_step.step'):
      return self._step(state, action, gen)

  def _step(self, state, action, gen):
    b, dev = self.batch_size, self.device
    # The drift advances before the beam lands: the beam misses by one
    # increment.
    drift = state.drift
    d = self.drift_per_frame_angstroms
    if d > 0.0:
      drift = drift + (torch.rand((b, 2), generator=gen, device=dev)
                       * (2.0 * d) - d)
    action = torch.clamp(action, -1.0, 1.0)
    if self.action_mode == 'relative':
      # Offset from the observed anchor dopant of the last frame.
      si = self._si_positions(state) + state.drift[:, None, :]  # (B, D, 2)
      pick_d = self._anchor_index(state, si)  # (B,)
      anchor = si[torch.arange(b, device=dev), pick_d]  # (B, 2)
      beam = anchor + action * self.max_distance_angstroms
    else:
      frac = (action + 1.0) / 2.0
      beam = state.fov_lower + frac * (state.fov_upper - state.fov_lower)
    # Believed-frame coordinates sit at +drift from the true sample.
    beam = beam - drift

    with profiling.span('kmc.apply_control'):
      result = kmc.apply_control_multi(
          gen, self.lattice, state.offset, state.theta, state.si_indices,
          beam, torch.full((b,), self.dwell_seconds, device=dev),
          self.rate_fn, max_events=self.max_kmc_events_per_step,
      )
    elapsed = torch.full(
        (b,), self.dwell_seconds + self.image_duration_seconds, device=dev)
    new_state = dataclasses.replace(
        state,
        si_indices=result.si_indices,
        steps=state.steps + 1,
        drift=drift,
        kmc_truncation_count=state.kmc_truncation_count
        + result.truncated.to(torch.int32),
    )

    si = self._si_positions(new_state)  # (B, D, 2)
    goal_radius = constants.CARBON_BOND_DISTANCE_ANGSTROMS * 0.5
    at_goal = torch.linalg.vector_norm(
        si - new_state.goals, dim=-1) < goal_radius  # (B, D)
    # The counter stays a true consecutive count; latching is a separate
    # boolean, so non-consecutive visits can never fake a completion.
    consecutive = torch.where(
        at_goal, new_state.consecutive + 1,
        torch.zeros_like(new_state.consecutive))
    reached = consecutive >= goals_lib.REQUIRED_CONSECUTIVE_GOAL_STEPS
    # With sticky goals a dopant's goal latches once reached (the beam
    # then works on the others).
    latched = (new_state.latched | reached) if self.sticky_goals else reached

    all_done = torch.all(latched, dim=-1)
    truncated = new_state.steps >= self.step_limit
    gamma = torch.pow(constants.GAMMA_PER_SECOND, elapsed).to(torch.float32)
    zeros = torch.zeros_like(gamma)
    reward = torch.where(all_done, gamma, zeros)
    discount = torch.where(all_done, zeros, gamma)
    last = all_done | truncated
    step_type = torch.where(
        last, torch.full_like(new_state.steps, env_lib.LAST),
        torch.full_like(new_state.steps, env_lib.MID)).to(torch.int32)
    new_state = dataclasses.replace(
        new_state, consecutive=consecutive, latched=latched, needs_reset=last)

    # Auto-reset on the step after LAST: envs flagged needs_reset get a
    # fresh FIRST timestep instead of being stepped. The fresh batch is
    # skipped on steps where no env finished (the common case).
    needs = state.needs_reset
    with profiling.span('sync.reset_any'):
      any_reset = bool(needs.any())
    if any_reset:
      fresh = self._fresh_state(gen)

      def pick(fresh_leaf, stepped_leaf):
        mask = needs.reshape((b,) + (1,) * (stepped_leaf.dim() - 1))
        return torch.where(mask, fresh_leaf, stepped_leaf)

      new_state = structures.tree_map(pick, fresh, new_state)
      step_type = torch.where(
          needs, torch.full_like(step_type, env_lib.FIRST), step_type)
      reward = torch.where(needs, zeros, reward)
      discount = torch.where(needs, torch.ones_like(discount), discount)
      elapsed = torch.where(needs, zeros, elapsed)
    ts = env_lib.TimeStep(
        step_type=step_type,
        reward=reward,
        discount=discount,
        observation=self._observation(new_state, gen),
        elapsed_seconds=elapsed,
    )
    return new_state, ts
