"""Batched agent evaluation (port of putting_dune_tpu/eval_lib.py).

`evaluate_batched` runs a whole suite as one batch of environments on the
env's device; each env stops contributing once its episode ends. The steps
run in chunks of `chunk_steps` with no host sync inside a chunk: the wall
clock is sampled at the start of each chunk, and "all done" and the step
cap are read between chunks. Inside a chunk the loop also stops once an
earlier step's "all done", copied to the host without a sync, reads true
(`_DonePoll`), as JAX's device loop checks it in its condition; the steps
run after every episode is done change no result. The combined budget
(simulated env seconds + that batch-shared wall clock, 600 s by default)
truncates live episodes at every step. A policy is a `(gen, observation)
-> action` callable or a `StatefulPolicy`, whose state the loop carries on
the device.

`evaluate` is the host per-seed loop over the single-env wrapper
(env/dm_env_wrapper.py) and a host agent's `step`: each episode's budget
counts simulated seconds plus the agent's own wall seconds, as the JAX
package's host evaluator does.

Both write episode videos, `{seed}.gif`, into `video_save_dir`
(plotting_utils draws the frames, io/gif.py writes them). The batched
loop records only (si, offset, theta, goal) of the first `video_envs` envs
each step, on the device, and rebuilds the atom clouds on the host after
the episode: within an episode the lattice pose is frozen, so that is
the whole scene. Recording draws nothing, so a run with videos gives the
results of the same run without them.

With a `mesh` (parallel/mesh.py, one rank per device) `evaluate_batched`
splits the seeds over the ranks in contiguous blocks; each rank's env
holds its block, seeded from that block (at world 1 the unsharded
run's stream), and the results come back in seed order on every rank.
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
from putting_dune_torch.utils import profiling

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

  @property
  def seconds_to_goal(self) -> float:
    return self.agent_seconds_to_goal + self.environment_seconds_to_goal


@dataclasses.dataclass(frozen=True)
class AggregateEvalResults:
  """Averages over goal-reaching episodes."""

  average_num_times_reached_goal: float
  average_num_actions_taken: float
  average_agent_seconds_to_goal: float
  average_environment_seconds_to_goal: float
  average_total_reward: float
  evaluator: str = ''

  @property
  def average_seconds_to_goal(self) -> float:
    return (self.average_agent_seconds_to_goal
            + self.average_environment_seconds_to_goal)


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
    max_steps: Optional[int] = None,
    video_save_dir: Optional[str] = None,
    video_envs: int = 4,
    chunk_steps: int = 64,
    mesh=None,
) -> List[EvalResult]:
  """Evaluates a batched policy over one batch of environments.

  Args:
    env: the batched environment (PuttingDuneEnv or MultiDopantEnv);
      env.batch_size must equal len(seeds).
    policy: (gen, observation) -> action, or a StatefulPolicy.
    seeds: one seed per environment; the generator is seeded from the
      whole list (suite_seed).
    timeout_seconds: combined per-episode budget: simulated seconds plus
      the batch-shared wall clock since the rollout started, sampled at
      the start of each chunk, so truncation is accurate to one chunk.
    max_steps: the step cap; None reads env.config.step_limit or
      env.step_limit (600 if neither).
    video_save_dir: if set, `{seed}.gif` for each of the first
      `video_envs` environments, min(steps + 1, step cap + 1) frames.
    video_envs: how many leading environments to record.
    chunk_steps: steps run between two host checks of the wall clock, of
      "all done" and of the step cap; inside a chunk "all done" is read
      without a sync (see the module docstring). Steps after every
      episode is done change no result.
    mesh: a parallel.mesh.Mesh with a 'data' axis: `seeds` is the whole
      suite and env.batch_size this rank's block of it. Not with videos.

  Returns:
    One EvalResult per seed, in order.
  """
  if mesh is not None and video_save_dir:
    raise ValueError(
        'mesh-sharded evaluation does not support video capture; run the '
        'video pass unsharded.')
  if chunk_steps < 1:
    raise ValueError(f'chunk_steps={chunk_steps} must be at least 1')
  all_seeds = list(seeds)
  if mesh is not None:
    from putting_dune_torch.parallel import mesh as mesh_lib

    seeds = mesh_lib.local_block(all_seeds, mesh)
  if env.batch_size != len(seeds):
    raise ValueError(
        f'env.batch_size={env.batch_size} != len(seeds)={len(seeds)}')
  if max_steps is None:
    # PuttingDuneEnv keeps the limit in its config, MultiDopantEnv inline.
    config = getattr(env, 'config', None)
    max_steps = (getattr(config, 'step_limit', None)
                 or getattr(env, 'step_limit', None) or 600)
  device = env.device
  gen = env_lib.make_generator(suite_seed(seeds), device)

  with torch.inference_mode():
    # The loop's own work sits under `eval_loop.setup` and
    # `eval_loop.accounting`; its calls into the policy and the env under
    # their spans, so that a bare `eval_loop.step` holds only the calls.
    state, ts = env.reset(gen)
    with profiling.span('eval_loop.setup'):
      batch = env.batch_size
      done = torch.zeros((batch,), dtype=torch.bool, device=device)
      reached = torch.zeros_like(done)
      steps = torch.zeros((batch,), dtype=torch.int32, device=device)
      env_seconds = ts.elapsed_seconds.clone()
      reward = torch.zeros((batch,), device=device)
      kmc_truncations = 0
      prev_trunc = state.kmc_truncation_count
      first = ts.first()
      pstate, policy_step = policy_stepper(policy, ts.observation)
      nvid = min(video_envs, batch) if video_save_dir else 0
      recorder = _PoseRecorder(state, nvid, max_steps + 1) if nvid else None
      poll = _DonePoll(device)

    t_start = time.perf_counter()
    t = 0
    while t < max_steps:
      wall = time.perf_counter() - t_start
      if wall >= timeout_seconds:
        break
      chunk_end = min(t + chunk_steps, max_steps)
      while t < chunk_end and not poll.all_done(done):
        with profiling.span('eval_loop.step'):
          pstate, action = policy_step(pstate, gen, ts.observation, first)
          state, ts = env.step(state, action, gen)
          with profiling.span('eval_loop.accounting'):
            first = ts.first()
            live = ~done
            steps = steps + live.to(torch.int32)
            env_seconds = env_seconds + torch.where(
                live, ts.elapsed_seconds,
                torch.zeros_like(ts.elapsed_seconds))
            reward = reward + torch.where(live, ts.reward,
                                          torch.zeros_like(ts.reward))
            terminal = live & (ts.step_type == env_lib.LAST)
            reached = reached | (terminal & (ts.discount == 0.0))
            done = done | terminal | (live & first)
            done = done | (env_seconds + wall > timeout_seconds)
            kmc_truncations = kmc_truncations + torch.sum(
                live & (state.kmc_truncation_count > prev_trunc))
            prev_trunc = state.kmc_truncation_count
            t += 1
            if recorder is not None:
              recorder.record(t, state)
      with profiling.span('eval_loop.accounting'):
        with profiling.span('sync.eval_done_all'):
          all_done = bool(done.all())
      if all_done:
        break

  with profiling.span('eval_loop.accounting'):
    with profiling.span('sync.eval_results'):
      kmc_truncations = int(kmc_truncations)
  if kmc_truncations > 0:
    logging.warning(
        'evaluate_batched: the KMC max_events safety cap truncated %d '
        'step(s); affected episodes ran incomplete dynamics.',
        kmc_truncations)
  with profiling.span('eval_loop.accounting'):
    with profiling.span('sync.eval_results'):
      reached_l = reached.tolist()
    with profiling.span('sync.eval_results'):
      steps_l = steps.tolist()
    with profiling.span('sync.eval_results'):
      secs_l = env_seconds.tolist()
    with profiling.span('sync.eval_results'):
      reward_l = reward.tolist()
  if recorder is not None:
    save_batched_videos(env, seeds, steps_l, recorder.host(), video_save_dir)
  results = [
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
  if mesh is not None:
    results = mesh_lib.gather_blocks(results, mesh)
  return results


class _DonePoll:
  """Whether every episode is done, read without a host sync: each call
  reads the copy of `done.all()` that an earlier call enqueued to pinned
  host memory, if the copy has landed, and enqueues the next one. On the
  CPU the copy lands at once, so a call reads the previous call's flag."""

  def __init__(self, device):
    self.cuda = device.type == 'cuda'
    self.host = torch.zeros((), dtype=torch.bool, pin_memory=self.cuda)
    self.event = torch.cuda.Event() if self.cuda else None
    self.pending = False

  def all_done(self, done: torch.Tensor) -> bool:
    with profiling.span('eval_loop.accounting'):
      if self.pending:
        if self.cuda and not self.event.query():
          return False
        if bool(self.host):
          return True
      self.host.copy_(done.all(), non_blocking=self.cuda)
      if self.cuda:
        self.event.record()
      self.pending = True
      return False


def video_pose(state, count: int):
  """(si (n, D), offset (n, 2), theta (n,), goals (n, D, 2)) of the first
  `count` envs; the single-dopant env is the D = 1 case."""
  if hasattr(state, 'sim'):
    material = state.sim.material
    return (material.si_index[:count, None], material.offset[:count],
            material.theta[:count],
            state.goal.position_material[:count, None, :])
  return (state.si_indices[:count], state.offset[:count],
          state.theta[:count], state.goals[:count])


class _PoseRecorder:
  """(cap, nvid, ...) buffers on the env's device; row t holds the poses
  after t steps. Writing a row reads the state and draws nothing."""

  def __init__(self, state, nvid: int, cap: int):
    self.nvid = nvid
    pose = video_pose(state, nvid)
    self.buffers = [torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                                device=x.device) for x in pose]
    self.record(0, state)

  def record(self, t: int, state) -> None:
    for buf, x in zip(self.buffers, video_pose(state, self.nvid)):
      buf[t].copy_(x)

  def host(self) -> dict:
    si, offset, theta, goal = (b.cpu().numpy() for b in self.buffers)
    return dict(si=si, offset=offset, theta=theta, goal=goal)


def video_scenes(lattice, video, i: int, count: int):
  """The first `count` recorded scenes of env i: (positions (count, N, 2),
  atomic numbers (count, N), goals (D, 2)), rebuilt on the host from the
  recorded poses (the JAX package's `_save_batched_videos`)."""
  from putting_dune_torch import lattice as lattice_lib
  from putting_dune_torch import plotting_utils

  host = lattice_lib.Lattice(lattice.positions.cpu(), lattice.neighbors.cpu())
  positions, numbers = plotting_utils.material_scene(
      host, video['offset'][:count, i], video['theta'][:count, i],
      video['si'][:count, i])
  return positions, numbers, np.asarray(video['goal'][0, i])


def save_batched_videos(env, seeds, steps, video, save_dir: str
                        ) -> List[str]:
  """Writes `{seed}.gif` for each recorded env: min(steps + 1, cap)
  frames. Returns the paths."""
  import os

  from putting_dune_torch import plotting_utils

  os.makedirs(save_dir, exist_ok=True)
  cap = video['si'].shape[0]
  paths = []
  for i in range(video['si'].shape[1]):
    count = min(int(steps[i]) + 1, cap)
    positions, numbers, goal = video_scenes(env.lattice, video, i, count)
    clip = plotting_utils.generate_video_from_trajectory(
        positions, numbers, goal_position=goal)
    path = os.path.join(save_dir, f'{int(seeds[i])}.gif')
    clip.save(path)
    paths.append(path)
  return paths


def _snapshot_frame(env):
  """(positions, atomic numbers, goal) of the wrapper's current state."""
  from putting_dune_torch import plotting_utils

  state = env._state  # pylint: disable=protected-access
  material = state.sim.material
  world, numbers = plotting_utils.material_scene(
      env.env.lattice, material.offset[0], material.theta[0],
      material.si_index[0])
  goal = state.goal.position_material[0].cpu().numpy()
  return world, numbers, goal


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
  With `video_save_dir`, every step is snapshotted and the episode written
  as `{seed}.gif`.
  """
  import os

  agent.set_mode(agent_lib.AgentMode.EVAL)
  results = []
  for seed in seeds:
    env.seed(seed)
    time_step = env.reset()
    agent_elapsed = 0.0
    env_elapsed = float(env.last_elapsed_seconds)
    num_actions = 0
    total_reward = 0.0
    frames = []
    if video_save_dir is not None:
      frames.append(_snapshot_frame(env))
    while agent_elapsed + env_elapsed < timeout.total_seconds():
      t0 = time.perf_counter()
      action = agent.step(time_step)
      agent_elapsed += time.perf_counter() - t0
      time_step = env.step(action)
      env_elapsed += float(env.last_elapsed_seconds)
      num_actions += 1
      if time_step.reward is not None:
        total_reward += float(time_step.reward)
      if video_save_dir is not None:
        frames.append(_snapshot_frame(env))
      if time_step.last():
        break
    if frames:
      from putting_dune_torch import plotting_utils

      os.makedirs(video_save_dir, exist_ok=True)
      plotting_utils.generate_video_from_trajectory(
          [f[0] for f in frames], [f[1] for f in frames],
          goal_position=frames[0][2]).save(
              os.path.join(video_save_dir, f'{seed}.gif'))
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
