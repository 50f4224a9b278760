"""A small deterministic batched env in PyTorch, for holding the trainers
update for update (tests/test_torch_ppo.py, tests/test_torch_distill.py
and, on the card, tests/test_torch_cuda.py). It imports nothing of JAX;
tests/jax_toy_env.py writes the same env in jax.numpy.

The state is a 2-d position per env: each step it moves to 0.9 p + 0.5 a
(a clipped to [-1, 1]). Within RADIUS of the origin the episode ends
(reward 1, discount 0); after LIMIT steps it is truncated (discount
DISCOUNT). The next step starts a new episode at the next row of a fixed
table of starts (reward 0, FIRST). The observation is [p, A p, -p], so
its last two entries are the goal delta; `shaping_distance` is 1.5 |p|.
The generator passed to reset and step is not used.
"""

import dataclasses
import types

import numpy as np
import torch

RADIUS = 0.3
LIMIT = 5
DISCOUNT = 0.99
OBS_MIX = np.array([[0.8, -0.3], [0.4, 1.1]], np.float32)
FIRST, MID, LAST = 0, 1, 2


def starts(batch, num_episodes=8, seed=0):
  """(num_episodes, batch, 2) episode starts, 0.5-1.5 from the origin."""
  rng = np.random.default_rng(seed)
  angle = rng.uniform(0, 2 * np.pi, (num_episodes, batch))
  radius = rng.uniform(0.5, 1.5, (num_episodes, batch))
  return np.stack([radius * np.cos(angle), radius * np.sin(angle)],
                  -1).astype(np.float32)


@dataclasses.dataclass
class State:
  pos: torch.Tensor
  steps: torch.Tensor
  episode: torch.Tensor
  needs_reset: torch.Tensor


@dataclasses.dataclass
class TimeStep:
  step_type: torch.Tensor
  reward: torch.Tensor
  discount: torch.Tensor
  observation: torch.Tensor

  def first(self):
    return self.step_type == FIRST


class ToyEnv:
  """The env above on `device` (batch = starts.shape[1])."""

  def __init__(self, start_table, device='cpu'):
    self.device = torch.device(device)
    self.starts = torch.as_tensor(start_table, device=self.device)
    self.batch_size = self.starts.shape[1]
    self.mix = torch.as_tensor(OBS_MIX, device=self.device)

  def observation_spec(self):
    return types.SimpleNamespace(shape=(6,))

  def action_spec(self):
    return types.SimpleNamespace(shape=(2,))

  def shaping_distance(self, obs):
    return 1.5 * torch.linalg.vector_norm(obs[:, :2], dim=-1)

  def _obs(self, pos):
    return torch.cat([pos, pos @ self.mix.T, -pos], dim=-1)

  def _start(self, episode):
    rows = torch.remainder(episode, self.starts.shape[0])
    return self.starts[rows, torch.arange(self.batch_size, device=self.device)]

  def reset(self, gen):
    del gen
    b = self.batch_size
    zeros = torch.zeros((b,), dtype=torch.int64, device=self.device)
    pos = self._start(zeros)
    state = State(pos, zeros, zeros, torch.zeros((b,), dtype=torch.bool,
                                                 device=self.device))
    ts = TimeStep(torch.full((b,), FIRST, device=self.device),
                  torch.zeros((b,), device=self.device),
                  torch.full((b,), DISCOUNT, device=self.device),
                  self._obs(pos))
    return state, ts

  def step(self, state, action, gen):
    del gen
    moved = 0.9 * state.pos + 0.5 * torch.clamp(action, -1.0, 1.0)
    steps = state.steps + 1
    terminal = torch.linalg.vector_norm(moved, dim=-1) < RADIUS
    last = terminal | (steps >= LIMIT)
    episode = torch.where(state.needs_reset, state.episode + 1, state.episode)
    fresh = self._start(episode)
    reset = state.needs_reset
    pos = torch.where(reset[:, None], fresh, moved)
    zero = torch.zeros_like(steps)
    new_state = State(pos, torch.where(reset, zero, steps), episode,
                      ~reset & last)
    step_type = torch.where(
        reset, torch.full_like(steps, FIRST),
        torch.where(last, torch.full_like(steps, LAST),
                    torch.full_like(steps, MID)))
    reward = torch.where(~reset & terminal, torch.ones_like(pos[:, 0]),
                         torch.zeros_like(pos[:, 0]))
    discount = torch.where(~reset & terminal, torch.zeros_like(reward),
                           torch.full_like(reward, DISCOUNT))
    return new_state, TimeStep(step_type, reward, discount, self._obs(pos))


def max_tree_diff(a, b) -> float:
  """The largest absolute difference between two nested dicts of arrays
  with the same keys."""

  def flat(tree, prefix=()):
    if hasattr(tree, 'items'):
      for k, v in tree.items():
        yield from flat(v, prefix + (k,))
    else:
      yield prefix, np.asarray(tree)

  fa, fb = dict(flat(a)), dict(flat(b))
  assert set(fa) == set(fb), set(fa) ^ set(fb)
  return max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)


def teacher(obs):
  """A deterministic controller over the toy observations: head for the
  origin, in [-1, 1]."""
  return torch.tanh(1.3 * obs[:, 4:6] + 0.2 * obs[:, 2:4])
