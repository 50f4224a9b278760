"""Batched agent evaluation (port of putting_dune_tpu/eval_lib.py).

`evaluate_batched` runs a whole suite as one batch of environments on the
env's device; each env stops contributing once its episode ends. The
combined budget (simulated env seconds + the batch-shared wall clock,
600 s by default) truncates live episodes, checked every step. A policy is
a `(gen, observation) -> action` callable or a `StatefulPolicy`, whose
state the loop carries on the device.

`evaluate` is the host per-seed loop over the single-env wrapper
(env/dm_env_wrapper.py) and a host agent's `step`: each episode's budget
counts simulated seconds plus the agent's own wall seconds, as the JAX
package's host evaluator does.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import hashlib
import logging
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from putting_dune_torch.agents import agent_lib
from putting_dune_torch.env import env as env_lib

EVAL_SUITES = {
    'tiny_eval': tuple(range(10)),
    'small_eval': tuple(range(100)),
    'medium_eval': tuple(range(1_000)),
    'big_eval': tuple(range(10_000)),
}

DEFAULT_TIMEOUT_SECONDS = 600.0

# Provenance of a result: the two evaluators time episodes differently.
BATCHED_EVALUATOR = 'batched(sim+wall)'
HOST_EVALUATOR = 'host(wall+sim-time)'

Policy = Callable[[torch.Generator, object], torch.Tensor]


class StatefulPolicy:
  """Protocol for policies that carry device state across steps (the
  in-loop drift corrector of agents/drift_correction.py tracks a frame
  history). Implementations provide

    init(example_obs) -> pstate        # tensors with a leading batch dim
    step(pstate, gen, obs, first) -> (pstate, action)

  `first` is the (B,) bool FIRST mask of the timestep the policy acts on:
  rows that auto-reset re-initialise their slice of the carried state.
  """

  def init(self, example_obs):
    raise NotImplementedError

  def step(self, pstate, gen, obs, first):
    raise NotImplementedError


def policy_stepper(policy, example_obs):
  """(pstate, step) for either kind of policy, with
  `step(pstate, gen, obs, first) -> (pstate, action)`; a stateless policy
  carries None and ignores `first`."""
  if isinstance(policy, StatefulPolicy):
    return policy.init(example_obs), policy.step
  return None, lambda pstate, gen, obs, first: (None, policy(gen, obs))


@dataclasses.dataclass(frozen=True)
class EvalResult:
  """Per-episode result; agent wall time is NaN in batched mode."""

  seed: int
  reached_goal: bool
  num_actions_taken: int
  agent_seconds_to_goal: float
  environment_seconds_to_goal: float
  total_reward: float
  evaluator: str = ''


@dataclasses.dataclass(frozen=True)
class AggregateEvalResults:
  """Averages over goal-reaching episodes."""

  average_num_times_reached_goal: float
  average_num_actions_taken: float
  average_agent_seconds_to_goal: float
  average_environment_seconds_to_goal: float
  average_total_reward: float
  evaluator: str = ''


def aggregate_results(results: Sequence[EvalResult]) -> AggregateEvalResults:
  reached = [r for r in results if r.reached_goal]
  denom = max(len(reached), 1)
  evaluators = sorted({r.evaluator for r in results})
  evaluator = (evaluators[0] if len(evaluators) == 1
               else 'mixed(' + ','.join(evaluators) + ')')
  return AggregateEvalResults(
      average_num_times_reached_goal=len(reached) / len(results),
      average_num_actions_taken=(
          sum(r.num_actions_taken for r in reached) / denom),
      average_agent_seconds_to_goal=(
          sum(r.agent_seconds_to_goal for r in reached) / denom),
      average_environment_seconds_to_goal=(
          sum(r.environment_seconds_to_goal for r in reached) / denom),
      average_total_reward=sum(r.total_reward for r in reached) / denom,
      evaluator=evaluator,
  )


def suite_seed(seeds: Sequence[int]) -> int:
  """One generator seed per seed list: a hash of the whole list, so two
  suites share a stream only if they are the same list."""
  data = np.asarray(list(seeds), np.int64).tobytes()
  return int.from_bytes(hashlib.sha256(data).digest()[:8], 'little') >> 1


def evaluate_batched(
    env,
    policy: Policy,
    seeds: Sequence[int],
    *,
    timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
    video_save_dir: Optional[str] = None,
) -> List[EvalResult]:
  """Evaluates a batched policy over one batch of environments.

  Args:
    env: the batched environment (PuttingDuneEnv or MultiDopantEnv);
      env.batch_size must equal len(seeds).
    policy: (gen, observation) -> action, or a StatefulPolicy.
    seeds: one seed per environment; the generator is seeded from the
      whole list (suite_seed).
    timeout_seconds: combined per-episode budget (simulated seconds plus
      the batch-shared wall clock since the rollout started); the step
      cap is env.config.step_limit or env.step_limit (600 if neither).
    video_save_dir: episode videos; not ported, so any value raises
      NotImplementedError.

  Returns:
    One EvalResult per seed, in order.
  """
  if video_save_dir is not None:
    raise NotImplementedError(
        'video_save_dir: episode videos wait for the port of plotting_utils.')
  if env.batch_size != len(seeds):
    raise ValueError(
        f'env.batch_size={env.batch_size} != len(seeds)={len(seeds)}')
  # PuttingDuneEnv keeps the limit in its config, MultiDopantEnv inline.
  config = getattr(env, 'config', None)
  max_steps = (getattr(config, 'step_limit', None)
               or getattr(env, 'step_limit', None) or 600)
  device = env.device
  gen = env_lib.make_generator(suite_seed(seeds), device)

  with torch.inference_mode():
    state, ts = env.reset(gen)
    batch = env.batch_size
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    reached = torch.zeros_like(done)
    steps = torch.zeros((batch,), dtype=torch.int32, device=device)
    env_seconds = ts.elapsed_seconds.clone()
    reward = torch.zeros((batch,), device=device)
    kmc_truncations = 0
    pstate, policy_step = policy_stepper(policy, ts.observation)

    t_start = time.perf_counter()
    for _ in range(max_steps):
      wall = time.perf_counter() - t_start
      if wall >= timeout_seconds:
        break
      pstate, action = policy_step(pstate, gen, ts.observation, ts.first())
      prev_trunc = state.kmc_truncation_count
      state, ts = env.step(state, action, gen)
      live = ~done
      steps = steps + live.to(torch.int32)
      env_seconds = env_seconds + torch.where(
          live, ts.elapsed_seconds, torch.zeros_like(ts.elapsed_seconds))
      reward = reward + torch.where(live, ts.reward,
                                    torch.zeros_like(ts.reward))
      terminal = live & (ts.step_type == env_lib.LAST)
      reached = reached | (terminal & (ts.discount == 0.0))
      done = done | terminal | (live & ts.first())
      done = done | (env_seconds + wall > timeout_seconds)
      kmc_truncations = kmc_truncations + torch.sum(
          live & (state.kmc_truncation_count > prev_trunc))
      if bool(done.all()):
        break

  kmc_truncations = int(kmc_truncations)
  if kmc_truncations > 0:
    logging.warning(
        'evaluate_batched: the KMC max_events safety cap truncated %d '
        'step(s); affected episodes ran incomplete dynamics.',
        kmc_truncations)
  reached_l = reached.tolist()
  steps_l = steps.tolist()
  secs_l = env_seconds.tolist()
  reward_l = reward.tolist()
  return [
      EvalResult(
          seed=int(seed),
          reached_goal=bool(reached_l[i]),
          num_actions_taken=int(steps_l[i]),
          agent_seconds_to_goal=float('nan'),
          environment_seconds_to_goal=(
              float(secs_l[i]) if reached_l[i] else float('nan')),
          total_reward=float(reward_l[i]),
          evaluator=BATCHED_EVALUATOR,
      )
      for i, seed in enumerate(seeds)
  ]


def evaluate(
    agent: agent_lib.Agent,
    env,
    seeds: Sequence[int],
    *,
    timeout: dt.timedelta = dt.timedelta(minutes=10),
    video_save_dir: Optional[str] = None,
) -> List[EvalResult]:
  """Host-loop evaluation, one episode per seed.

  `env` is the single-env wrapper (`run_helpers.create_putting_dune_env`);
  `agent` has the dm_env `step`. An episode ends at its LAST timestep or
  once its simulated seconds plus the agent's wall seconds reach `timeout`.
  """
  if video_save_dir is not None:
    raise NotImplementedError(
        'video_save_dir: episode videos wait for the port of plotting_utils.')
  agent.set_mode(agent_lib.AgentMode.EVAL)
  results = []
  for seed in seeds:
    env.seed(seed)
    time_step = env.reset()
    agent_elapsed = 0.0
    env_elapsed = float(env.last_elapsed_seconds)
    num_actions = 0
    total_reward = 0.0
    while agent_elapsed + env_elapsed < timeout.total_seconds():
      t0 = time.perf_counter()
      action = agent.step(time_step)
      agent_elapsed += time.perf_counter() - t0
      time_step = env.step(action)
      env_elapsed += float(env.last_elapsed_seconds)
      num_actions += 1
      if time_step.reward is not None:
        total_reward += float(time_step.reward)
      if time_step.last():
        break
    discount = 1.0 if time_step.discount is None else float(time_step.discount)
    reached_goal = bool(time_step.last() and discount == 0.0)
    results.append(EvalResult(
        seed=seed,
        reached_goal=reached_goal,
        num_actions_taken=num_actions,
        agent_seconds_to_goal=agent_elapsed if reached_goal else float('nan'),
        environment_seconds_to_goal=(
            env_elapsed if reached_goal else float('nan')),
        total_reward=total_reward,
        evaluator=HOST_EVALUATOR,
    ))
  return results
