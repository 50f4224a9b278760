"""Agents for Putting Dune (port of putting_dune_tpu/agents/agent_lib.py).

Two layers, as in the JAX package:

  * batched policies, `policy(gen, observation) -> action` on tensors, which
    the batched evaluator and the trainers drive;
  * host agents with the dm_env `step(time_step) -> action` interface
    (`Agent`, `UniformRandomAgent`, `GreedyAgent`) for the single-env
    wrapper (env/dm_env_wrapper.py) and the real-microscope loop
    (microscope_agent.py).
"""

from __future__ import annotations

import abc
import enum
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from putting_dune_torch import device as device_lib
from putting_dune_torch import geometry

# Beam offset (angstroms, for a neighbor toward +x) the greedy controller
# targets: directly on the neighbor.
DEFAULT_GREEDY_ARGMAX = (1.42, 0.0)


@enum.unique
class AgentMode(enum.Enum):
  TRAIN = 'train'
  EVAL = 'eval'


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
    fixed_offset: tuple[float, float] = (0.0, 0.0),
    position_noise_sigma: float = 0.0,
) -> torch.Tensor:
  """Greedy controller over 10-dim material-frame features.

  Picks the neighbor whose delta best matches the goal delta and places
  the beam at `argmax` + `fixed_offset` (+ N(0, sigma^2) noise per axis,
  drawn from `gen`) rotated to that neighbor's angle. Returns (B, 2) beam
  deltas from the silicon, angstroms.
  """
  batch = observation.shape[0]
  device = observation.device
  neighbor_deltas = observation[:, 2:8].reshape(batch, 3, 2)
  goal_delta = observation[:, 8:10]
  scores = torch.linalg.vector_norm(
      neighbor_deltas - goal_delta[:, None, :], dim=-1)
  best = torch.argmin(scores, dim=-1)
  angles = geometry.get_angles(neighbor_deltas)
  angle = torch.gather(angles, 1, best[:, None])[:, 0]
  beam = (torch.tensor(argmax, dtype=torch.float32, device=device)
          + torch.tensor(fixed_offset, dtype=torch.float32, device=device)
          ).expand(batch, 2)
  if position_noise_sigma > 0.0:
    if gen is None:
      raise ValueError('position_noise_sigma > 0 requires a generator.')
    beam = beam + position_noise_sigma * torch.randn(
        (batch, 2), generator=gen, device=device)
  return geometry.rotate_coordinates(beam, angle)


def _host(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def find_argmax(
    transition_function: Callable[[np.ndarray], np.ndarray],
    resolution: float = 0.05,
    low: float = -5.0,
    high: float = 5.0,
) -> np.ndarray:
  """Grid-search argmax of a transition function: the beam offset (2,)
  maximizing the rate of transitioning to the neighbor at (bond, 0). The
  function is called on each grid point (2,) and may return numpy arrays
  or tensors."""
  num_points = int((high - low) // resolution)
  pts = np.linspace(low, high, num_points, dtype=np.float32)
  xx = np.tile(pts[None], (num_points, 1))
  yy = np.tile(pts[:, None], (1, num_points))
  points = np.stack([xx, yy], axis=-1).reshape(-1, 2)
  probs = np.stack([_host(transition_function(p)) for p in points], 0)
  return points[np.argmax(probs[..., 0], axis=-1)]


# --- host dm_env-style agents ------------------------------------------------


class Agent(abc.ABC):
  """The dm_env-facing agent interface."""

  @abc.abstractmethod
  def step(self, time_step) -> np.ndarray:
    """Returns an action for the latest TimeStep."""

  @abc.abstractmethod
  def set_mode(self, mode: AgentMode) -> None:
    """Sets train/eval mode."""


class UniformRandomAgent(Agent):
  """Uniform random actions from the caller's numpy generator (the JAX
  agent's draws, given the same generator)."""

  def __init__(
      self,
      rng: np.random.Generator,
      low: Union[float, np.ndarray],
      high: Union[float, np.ndarray],
      size: Sequence[int],
  ):
    self._rng = rng
    self._low = low
    self._high = high
    self._size = tuple(size)

  def step(self, time_step) -> np.ndarray:
    del time_step
    return self._rng.uniform(self._low, self._high, self._size)

  def set_mode(self, mode: AgentMode) -> None:
    pass


class GreedyAgent(Agent):
  """Host wrapper over `greedy_policy` (material-frame features + the
  material-frame relative action adapter).

  The position noise comes from the caller's numpy generator as in the JAX
  agent: one `integers(2**31)` a step seeds a torch.Generator on the
  agent's device (CUDA unless asked otherwise; device.resolve_device).
  """

  def __init__(
      self,
      rng: Optional[np.random.Generator] = None,
      transition_function: Optional[
          Callable[[np.ndarray], np.ndarray]] = None,
      argmax: Optional[np.ndarray] = np.asarray(DEFAULT_GREEDY_ARGMAX),
      argmax_resolution: float = 0.05,
      position_noise_sigma: float = 0.0,
      fixed_offset: np.ndarray = np.zeros(2, dtype=np.float32),
      low: float = -5.0,
      high: float = 5.0,
      device=None,
  ):
    self._rng = rng if rng is not None else np.random.default_rng()
    self._position_noise_sigma = position_noise_sigma
    self._fixed_offset = np.asarray(fixed_offset, np.float32)
    self._device = device_lib.resolve_device(device)
    if transition_function is not None:
      self._argmax = find_argmax(
          transition_function, argmax_resolution, low, high)
    elif argmax is not None:
      self._argmax = np.asarray(argmax, np.float32)
    else:
      raise ValueError('One of transition_function or argmax must be set.')

  def step(self, time_step) -> np.ndarray:
    obs = torch.as_tensor(
        np.asarray(time_step.observation, np.float32).reshape(1, 10),
        device=self._device)
    gen = None
    if self._position_noise_sigma > 0.0:
      gen = torch.Generator(device=self._device)
      gen.manual_seed(int(self._rng.integers(2**31)))
    action = greedy_policy(
        gen, obs,
        argmax=tuple(self._argmax.tolist()),
        fixed_offset=tuple(self._fixed_offset.tolist()),
        position_noise_sigma=self._position_noise_sigma,
    )
    return action[0].cpu().numpy()

  def set_mode(self, mode: AgentMode) -> None:
    pass
