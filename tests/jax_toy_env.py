"""tests/torch_toy_env.py's deterministic env in jax.numpy, for the JAX
trainers (putting_dune_tpu.agents.ppo and .distill); it ignores its keys."""

from typing import NamedTuple

import jax
import jax.numpy as jnp

import torch_toy_env


class _JState(NamedTuple):
  pos: jax.Array
  steps: jax.Array
  episode: jax.Array
  needs_reset: jax.Array


class _JTimeStep(NamedTuple):
  step_type: jax.Array
  reward: jax.Array
  discount: jax.Array
  observation: jax.Array

  def first(self):
    return self.step_type == torch_toy_env.FIRST


class _Spec(NamedTuple):
  shape: tuple


class JaxToyEnv:
  def __init__(self, start_table):
    self.starts = jnp.asarray(start_table)
    self.batch_size = start_table.shape[1]
    self.mix = jnp.asarray(torch_toy_env.OBS_MIX)

  def observation_spec(self):
    return _Spec((6,))

  def action_spec(self):
    return _Spec((2,))

  def shaping_distance(self, obs):
    return 1.5 * jnp.linalg.norm(obs[:, :2], axis=-1)

  def _obs(self, pos):
    return jnp.concatenate([pos, pos @ self.mix.T, -pos], axis=-1)

  def _start(self, episode):
    rows = jnp.remainder(episode, self.starts.shape[0])
    return self.starts[rows, jnp.arange(self.batch_size)]

  def reset(self, key):
    del key
    b = self.batch_size
    zeros = jnp.zeros((b,), jnp.int32)
    pos = self._start(zeros)
    return (_JState(pos, zeros, zeros, jnp.zeros((b,), bool)),
            _JTimeStep(jnp.full((b,), torch_toy_env.FIRST), jnp.zeros((b,)),
                       jnp.full((b,), torch_toy_env.DISCOUNT), self._obs(pos)))

  def step(self, state, action, key):
    del key
    moved = 0.9 * state.pos + 0.5 * jnp.clip(action, -1.0, 1.0)
    steps = state.steps + 1
    terminal = jnp.linalg.norm(moved, axis=-1) < torch_toy_env.RADIUS
    last = terminal | (steps >= torch_toy_env.LIMIT)
    episode = jnp.where(state.needs_reset, state.episode + 1, state.episode)
    reset = state.needs_reset
    pos = jnp.where(reset[:, None], self._start(episode), moved)
    new_state = _JState(pos, jnp.where(reset, 0, steps), episode,
                        ~reset & last)
    step_type = jnp.where(reset, torch_toy_env.FIRST,
                          jnp.where(last, torch_toy_env.LAST,
                                    torch_toy_env.MID))
    reward = jnp.where(~reset & terminal, 1.0, 0.0)
    discount = jnp.where(~reset & terminal, 0.0, torch_toy_env.DISCOUNT)
    return new_state, _JTimeStep(step_type, reward, discount, self._obs(pos))
