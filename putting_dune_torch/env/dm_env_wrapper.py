"""A single-environment wrapper with the dm_env surface.

Port of putting_dune_tpu/env/dm_env_wrapper.py without the dm_env package:
`StepType`, `TimeStep` and the array specs are this module's own, with
dm_env's semantics. The wrapper drives a batch-1 `PuttingDuneEnv` and hands
out host timesteps (numpy observations, Python floats):

  * `reset()` gives a FIRST timestep, which carries no reward or discount;
  * `step(action)` on a fresh environment, or after a LAST timestep, is a
    reset (the action is ignored);
  * `seed(seed)` reseeds the wrapper's generator and asks for a reset;
  * `render()` draws the current state (plotting_utils.render_env_frame).

Use the batched environment for throughput; this wrapper serves the host
agents, the host evaluator (`eval_lib.evaluate`) and contract tests.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from putting_dune_torch.env import env as env_lib


class StepType(enum.IntEnum):
  FIRST = 0
  MID = 1
  LAST = 2

  def first(self) -> bool:
    return self is StepType.FIRST

  def mid(self) -> bool:
    return self is StepType.MID

  def last(self) -> bool:
    return self is StepType.LAST


class TimeStep(NamedTuple):
  """A host timestep: reward and discount are None on FIRST."""

  step_type: StepType
  reward: Optional[float]
  discount: Optional[float]
  observation: Any

  def first(self) -> bool:
    return self.step_type is StepType.FIRST

  def mid(self) -> bool:
    return self.step_type is StepType.MID

  def last(self) -> bool:
    return self.step_type is StepType.LAST


def restart(observation) -> TimeStep:
  return TimeStep(StepType.FIRST, None, None, observation)


def transition(reward: float, observation, discount: float = 1.0
               ) -> TimeStep:
  return TimeStep(StepType.MID, reward, discount, observation)


def termination(reward: float, observation) -> TimeStep:
  return TimeStep(StepType.LAST, reward, 0.0, observation)


def truncation(reward: float, observation, discount: float = 1.0
               ) -> TimeStep:
  return TimeStep(StepType.LAST, reward, discount, observation)


@dataclasses.dataclass(frozen=True)
class Array:
  """dm_env's `specs.Array`: a shape and a dtype."""

  shape: tuple
  dtype: Any

  def validate(self, value):
    value = np.asarray(value)
    if value.shape != tuple(self.shape):
      raise ValueError(f'Expected shape {self.shape}, got {value.shape}.')
    if value.dtype != np.dtype(self.dtype):
      raise ValueError(f'Expected dtype {self.dtype}, got {value.dtype}.')
    return value

  def generate_value(self):
    return np.zeros(self.shape, self.dtype)


@dataclasses.dataclass(frozen=True)
class BoundedArray(Array):
  """dm_env's `specs.BoundedArray`: an Array within [minimum, maximum]."""

  minimum: Any = None
  maximum: Any = None

  def validate(self, value):
    value = super().validate(value)
    if (value < self.minimum).any() or (value > self.maximum).any():
      raise ValueError(
          f'Values out of [{self.minimum}, {self.maximum}]: {value}.')
    return value

  def generate_value(self):
    return np.broadcast_to(np.asarray(self.minimum, self.dtype),
                           self.shape).copy()


def _host_observation(observation):
  if isinstance(observation, dict):
    return {k: v[0].cpu().numpy() for k, v in observation.items()}
  return observation[0].cpu().numpy()


def _to_host_timestep(ts: env_lib.TimeStep) -> TimeStep:
  obs = _host_observation(ts.observation)
  step_type = StepType(int(ts.step_type[0]))
  if step_type is StepType.FIRST:
    return restart(obs)
  return TimeStep(step_type, float(ts.reward[0]), float(ts.discount[0]), obs)


class DmEnvWrapper:
  """dm_env's Environment surface over a batch_size=1 PuttingDuneEnv."""

  def __init__(self, env: env_lib.PuttingDuneEnv, seed: Optional[int] = None):
    if env.batch_size != 1:
      raise ValueError('DmEnvWrapper requires batch_size=1.')
    self._env = env
    self._state: Optional[env_lib.EnvState] = None
    self.seed(seed)
    self.last_elapsed_seconds = 0.0

  @property
  def env(self) -> env_lib.PuttingDuneEnv:
    return self._env

  def seed(self, seed: Optional[int]) -> None:
    self._gen = env_lib.make_generator(0 if seed is None else seed,
                                       self._env.device)
    self._requires_reset = True

  def reset(self) -> TimeStep:
    with torch.inference_mode():
      self._state, ts = self._env.reset(self._gen)
    self._requires_reset = False
    self.last_elapsed_seconds = float(ts.elapsed_seconds[0])
    return _to_host_timestep(ts)

  def step(self, action) -> TimeStep:
    if self._requires_reset or self._state is None:
      return self.reset()
    action = torch.as_tensor(
        np.asarray(action, np.float32).reshape(1, -1),
        device=self._env.device)
    with torch.inference_mode():
      self._state, ts = self._env.step(self._state, action, self._gen)
    if int(ts.step_type[0]) == env_lib.LAST:
      self._requires_reset = True
    self.last_elapsed_seconds = float(ts.elapsed_seconds[0])
    return _to_host_timestep(ts)

  def action_spec(self) -> BoundedArray:
    spec = self._env.action_spec()
    return BoundedArray(
        shape=tuple(spec.shape), dtype=spec.dtype,
        minimum=np.asarray(spec.minimum, spec.dtype),
        maximum=np.asarray(spec.maximum, spec.dtype))

  def observation_spec(self):
    spec = self._env.observation_spec()
    if isinstance(spec, dict):
      return {k: Array(tuple(v.shape), v.dtype) for k, v in spec.items()}
    return Array(tuple(spec.shape), spec.dtype)

  def reward_spec(self) -> Array:
    return Array((), np.float64)

  def discount_spec(self) -> BoundedArray:
    return BoundedArray((), np.float64, minimum=0.0, maximum=1.0)

  def render(self) -> np.ndarray:
    """The current state as a (500, 500, 3) uint8 frame
    (plotting_utils.render_env_frame)."""
    from putting_dune_torch import plotting_utils

    if self._state is None:
      raise RuntimeError('render() before reset()')
    return plotting_utils.render_env_frame(self._env, self._state)

  def close(self) -> None:
    pass
