"""The batched Putting Dune RL environment.

Port of putting_dune_tpu/env/env.py:

    state, ts = env.reset(gen)
    state, ts = env.step(state, action, gen)

Environments whose previous step ended the episode are reset inside
step(): when at most `reset_chunk` finished, fresh states are built for
just those envs and scattered back; otherwise a full fresh batch is built
and selected per env. The STEM image is rendered once, after that
selection, through the believed FOV shifted by the instrument drift (see
simulator.py): the camera sees the drifted world, while goals are judged
on the true silicon. dm_env semantics per env:

  * FIRST: reward 0, discount gamma**elapsed;
  * terminal: discount 0;
  * truncation at step_limit: discount gamma**elapsed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch import simulator as simulator_lib
from putting_dune_torch import structures
from putting_dune_torch.env import action_adapters
from putting_dune_torch.env import features as features_lib
from putting_dune_torch.env import goals as goals_lib
from putting_dune_torch.imaging import render as imaging_render

FIRST = 0
MID = 1
LAST = 2


@dataclasses.dataclass
class TimeStep:
  """Batched dm_env-style timestep: step_type (B,) int32, reward and
  discount (B,) f32, observation features, elapsed_seconds (B,)."""

  step_type: torch.Tensor
  reward: torch.Tensor
  discount: torch.Tensor
  observation: Any
  elapsed_seconds: torch.Tensor

  def first(self) -> torch.Tensor:
    return self.step_type == FIRST

  def last(self) -> torch.Tensor:
    return self.step_type == LAST


@dataclasses.dataclass
class EnvState:
  """Full batched environment state."""

  sim: structures.SimulatorState
  goal: goals_lib.GoalState
  adapter_state: Any
  step_count: torch.Tensor  # (B,) int32
  needs_reset: torch.Tensor  # (B,) bool: previous step ended the episode.
  kmc_truncation_count: torch.Tensor  # (B,) int32


@dataclasses.dataclass(frozen=True)
class EnvConfig:
  sim: simulator_lib.SimulatorConfig = simulator_lib.SimulatorConfig()
  step_limit: Optional[int] = 600
  # Auto-reset sub-batch capacity (see the module docstring).
  reset_chunk: int = 64


def make_generator(seed: int, device) -> torch.Generator:
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed))
  return gen


def _discount(elapsed: torch.Tensor) -> torch.Tensor:
  return torch.pow(constants.GAMMA_PER_SECOND, elapsed).to(torch.float32)


@dataclasses.dataclass
class PuttingDuneEnv:
  """Batched environment.

  Attributes:
    lattice: static lattice; built from config.sim.grid_columns if None.
    rate_fn: batched KMC rate function.
    adapter: action adapter.
    features: feature constructor.
    config: env/simulator config.
    batch_size: number of parallel environments.
    device: 'cuda' by default; raises if CUDA is absent unless 'cpu'.
  """

  lattice: Optional[lattice_lib.Lattice] = None
  rate_fn: rates_lib.RateFunction = rates_lib.prior_rates
  adapter: Any = action_adapters.RelativeToSiliconActionAdapter()
  features: Any = features_lib.SingleSiliconPristineGrapheneFeatures()
  config: EnvConfig = EnvConfig()
  batch_size: int = 1
  device: Any = None

  def __post_init__(self):
    self.device = device_lib.resolve_device(self.device)
    if self.lattice is None:
      self.lattice = lattice_lib.make_lattice(
          self.config.sim.grid_columns, self.device)
    elif self.lattice.device != self.device:
      self.lattice = lattice_lib.Lattice(
          self.lattice.positions.to(self.device),
          self.lattice.neighbors.to(self.device),
      )

  # -- internals ------------------------------------------------------------

  def _fresh_state_and_obs(self, gen, render_image=True, batch_size=None):
    batch_size = self.batch_size if batch_size is None else batch_size
    sim_state, obs = simulator_lib.reset(
        gen, self.lattice, config=self.config.sim, batch_size=batch_size,
        return_window=self.features.requires_window or (
            self.features.requires_image and render_image),
        return_image=self.features.requires_image and render_image,
    )
    goal = goals_lib.sample_goal(gen, self.lattice, sim_state.material,
                                 sim_state.fov)
    adapter_state = self.adapter.init_state(gen, batch_size)
    zeros = torch.zeros((batch_size,), dtype=torch.int32, device=self.device)
    state = EnvState(
        sim=sim_state, goal=goal, adapter_state=adapter_state,
        step_count=zeros,
        needs_reset=torch.zeros((batch_size,), dtype=torch.bool,
                                device=self.device),
        kmc_truncation_count=zeros.clone(),
    )
    return state, obs

  # -- public API -----------------------------------------------------------

  def reset(self, gen: torch.Generator) -> tuple[EnvState, TimeStep]:
    state, obs = self._fresh_state_and_obs(gen)
    b = self.batch_size
    ts = TimeStep(
        step_type=torch.full((b,), FIRST, dtype=torch.int32,
                             device=self.device),
        reward=torch.zeros((b,), device=self.device),
        discount=_discount(obs.elapsed_seconds),
        observation=self.features(obs, state.goal),
        elapsed_seconds=obs.elapsed_seconds,
    )
    return state, ts

  def step(self, state: EnvState, action: torch.Tensor,
           gen: torch.Generator) -> tuple[EnvState, TimeStep]:
    """Advances every environment one step (auto-resetting finished ones)."""
    material = state.sim.material
    si_prev = lattice_lib.site_position(
        self.lattice, material.si_index, material.offset, material.theta)
    # The adapter aims at the silicon observed in the last frame, the true
    # position plus the cumulative drift.
    ctx = action_adapters.AdapterContext(
        si_position_microscope=state.sim.fov.material_to_microscope(
            si_prev + state.sim.drift),
        fov=state.sim.fov,
    )
    adapter_state, control = self.adapter.to_controls(
        state.adapter_state, ctx, action)
    sim_state, obs, kmc_result = simulator_lib.step(
        state.sim, gen, control, self.lattice, self.rate_fn,
        config=self.config.sim,
        return_window=self.features.requires_window, return_image=False,
    )
    # A fresh episode's observation has no controls: drop them, as the JAX
    # package does, so that stepped and fresh observations match leaf for
    # leaf.
    obs = dataclasses.replace(obs, last_controls=None)
    new_material = sim_state.material
    si_material = lattice_lib.site_position(
        self.lattice, new_material.si_index, new_material.offset,
        new_material.theta)
    new_goal, goal_ret = goals_lib.reward_and_terminal(
        state.goal, si_material, obs.elapsed_seconds)
    step_count = state.step_count + 1
    terminal = goal_ret.is_terminal
    truncated = goal_ret.is_truncated
    if self.config.step_limit is not None:
      truncated = truncated | (
          (step_count >= self.config.step_limit) & ~terminal)
    discount = torch.where(terminal, torch.zeros_like(obs.elapsed_seconds),
                           _discount(obs.elapsed_seconds))
    step_type = torch.where(
        terminal | truncated,
        torch.full_like(step_count, LAST), torch.full_like(step_count, MID),
    ).to(torch.int32)
    stepped_state = EnvState(
        sim=sim_state, goal=new_goal, adapter_state=adapter_state,
        step_count=step_count, needs_reset=terminal | truncated,
        kmc_truncation_count=state.kmc_truncation_count
        + kmc_result.truncated.to(torch.int32),
    )

    # Raw observations are selected before features and rendering, so the
    # image is rendered exactly once per step.
    needs = state.needs_reset
    num_reset = int(needs.sum())
    chunk = min(self.config.reset_chunk, self.batch_size)
    if num_reset == 0:
      new_state, picked_obs = stepped_state, obs
    elif num_reset <= chunk and chunk < self.batch_size:
      idx = torch.nonzero(needs)[:, 0]
      fresh_state, fresh_obs = self._fresh_state_and_obs(
          gen, render_image=False, batch_size=num_reset)

      def scatter(stepped_leaf, fresh_leaf):
        out = stepped_leaf.clone()
        out[idx] = fresh_leaf
        return out

      new_state = structures.tree_map(scatter, stepped_state, fresh_state)
      picked_obs = structures.tree_map(scatter, obs, fresh_obs)
    else:
      fresh_state, fresh_obs = self._fresh_state_and_obs(
          gen, render_image=False)

      def pick(fresh_leaf, stepped_leaf):
        mask = needs.reshape((self.batch_size,)
                             + (1,) * (stepped_leaf.dim() - 1))
        return torch.where(mask, fresh_leaf, stepped_leaf)

      new_state = structures.tree_map(pick, fresh_state, stepped_state)
      picked_obs = structures.tree_map(pick, fresh_obs, obs)

    if self.features.requires_image:
      # The drifted world: the true lattice through the believed FOV
      # shifted by -drift (fresh rows have zero drift).
      render_fov = new_state.sim.fov.shift(-new_state.sim.drift)
      window = simulator_lib.atom_window(
          self.lattice, new_state.sim.material, render_fov,
          self.config.sim.window_capacity)
      image = imaging_render.render_stem_image(
          gen, window, render_fov, new_state.sim.imaging,
          image_size=self.config.sim.image_size)
      picked_obs = dataclasses.replace(picked_obs, image=image, window=window)
    observation = self.features(picked_obs, new_state.goal)

    ts = TimeStep(
        step_type=torch.where(needs, torch.full_like(step_type, FIRST),
                              step_type),
        reward=torch.where(needs, torch.zeros_like(goal_ret.reward),
                           goal_ret.reward),
        discount=torch.where(needs, _discount(picked_obs.elapsed_seconds),
                             discount),
        observation=observation,
        elapsed_seconds=picked_obs.elapsed_seconds,
    )
    return new_state, ts

  # -- specs ----------------------------------------------------------------

  def action_spec(self) -> action_adapters.ActionSpec:
    return self.adapter.spec()

  def observation_spec(self):
    return self.features.spec()
