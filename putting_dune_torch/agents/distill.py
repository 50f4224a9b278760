"""Planner-to-policy distillation by DAgger (port of
putting_dune_tpu/agents/distill.py).

The rate-aware planner (agents/planner.py) reaches goals the greedy rule
cannot, but scores a (B, K) grid of candidate beams every step. This
module distills it into the MLP head the shipped policies use, so its
behaviour deploys at the cost of one small MLP a step. Each iteration:

  roll the batched env `rollout_length` steps; at every visited state ask
  the teacher for its action and execute a beta-mixture of teacher and
  student actions (beta = init * decay^i, so later iterations label the
  student's own state distribution);
  write (obs, teacher action) into a device buffer of capacity
  num_iterations x rollout_length x batch, filled in order;
  take `sgd_steps_per_iteration` Adam steps on MSE(student, teacher), each
  on `minibatch_size` indices drawn uniformly, with replacement, from the
  filled prefix.

Everything stays on the env's device; the host reads one loss an
iteration. The mix uniforms and the indices are drawn from the run's
generator unless the caller passes them (`run_iteration(..., mix=,
indices=)`), which is how the tests hold an iteration to the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from putting_dune_torch import rates as rates_lib
from putting_dune_torch.agents import eval_agent
from putting_dune_torch.agents import planner as planner_lib
from putting_dune_torch.agents import ppo


@dataclasses.dataclass(frozen=True)
class DistillConfig:
  """Defaults sized for a few minutes of a card; shrink for tests."""

  num_iterations: int = 10
  rollout_length: int = 64
  sgd_steps_per_iteration: int = 256
  minibatch_size: int = 4096
  learning_rate: float = 3e-4
  hidden: Tuple[int, ...] = (256, 256)
  # Probability of executing the teacher's action: beta_i = init * decay^i.
  teacher_mix_init: float = 1.0
  teacher_mix_decay: float = 0.5
  # Action range of the tanh head, angstroms. Must cover the teacher's
  # candidate grid (planner.make_candidate_offsets max_radius).
  output_scale: float = 3.3
  # The default teacher's settings; the dwell must match the adapter's.
  dwell_seconds: float = 5.0
  lookahead_discount: float = 0.0
  num_radii: int = 10
  num_angles: int = 64
  # Variable-dwell distillation: the adapter's exact (min, max) dwell
  # range; actions gain a 3rd dim, the dwell as a [0, 1] fraction.
  dwell_range_seconds: Optional[Tuple[float, float]] = None
  num_dwells: int = 8
  image_duration_seconds: float = 2.0

  @property
  def action_dim(self) -> int:
    return 3 if self.dwell_range_seconds is not None else 2

  @property
  def head_output_scale(self):
    """Per-dim tanh scales: angstrom deltas at output_scale; the dwell
    fraction (variable-dwell mode) at 1 so MSE weighs it fairly."""
    if self.dwell_range_seconds is None:
      return self.output_scale
    return (self.output_scale, self.output_scale, 1.0)


def student_module(config: DistillConfig, obs_dim: int
                   ) -> eval_agent.MLPPolicy:
  return eval_agent.MLPPolicy(
      obs_dim=obs_dim, hidden=config.hidden, action_dim=config.action_dim,
      output_scale=config.head_output_scale)


@dataclasses.dataclass
class DistillCarry:
  """The student, its optimizer, the env state and timestep, the buffer
  and how much of it is filled, and the run's generator."""

  model: eval_agent.MLPPolicy
  optimizer: torch.optim.Optimizer
  env_state: object
  ts: object
  gen: torch.Generator
  buf_obs: torch.Tensor
  buf_act: torch.Tensor
  filled: int = 0


def default_teacher(rate_fn: rates_lib.RateFunction, config: DistillConfig
                    ) -> Callable:
  """The single-dopant rate-aware planner with the config's settings, as
  obs -> (B, action_dim)."""
  candidates = planner_lib.make_candidate_offsets(
      num_radii=config.num_radii, num_angles=config.num_angles)
  dwell_grid = None
  if config.dwell_range_seconds is not None:
    lo, hi = config.dwell_range_seconds
    dwell_grid = np.linspace(lo, hi, config.num_dwells, dtype=np.float32)

  def teacher(obs):
    return planner_lib.planner_policy(
        None, obs, rate_fn=rate_fn, dwell_seconds=config.dwell_seconds,
        candidates=candidates, lookahead_discount=config.lookahead_discount,
        dwell_grid_seconds=dwell_grid,
        image_duration_seconds=config.image_duration_seconds)

  return teacher


def make_distill_fns(env, rate_fn: Optional[rates_lib.RateFunction],
                     config: DistillConfig = DistillConfig(), teacher=None):
  """Builds (init_carry, run_iteration) for distillation on `env`'s device.

  init_carry(seed, init_params=None) -> DistillCarry: a student with
  flax's initialisers (or the given flax MLPPolicy tree), Adam, a reset
  env and an empty buffer, from one generator seeded with `seed` (or the
  generator passed).

  run_iteration(carry, beta, mix=None, indices=None) -> (carry, {'loss'})
  is one DAgger iteration; `mix` (rollout_length, B, 1) replaces the
  uniforms compared with beta and `indices` (sgd_steps_per_iteration,
  minibatch_size) the buffer rows of each step. 'loss' is the last step's.

  teacher: optional obs -> (B, action_dim) controller to imitate, with the
  env's action semantics (e.g. the multi-dopant planner). Default: the
  single-dopant planner over rate_fn (`default_teacher`).
  """
  if teacher is None:
    teacher = default_teacher(rate_fn, config)
  batch = env.batch_size
  device = env.device
  obs_dim = env.observation_spec().shape[0]
  samples = config.rollout_length * batch
  capacity = config.num_iterations * samples

  def init_carry(seed, init_params=None) -> DistillCarry:
    gen = seed
    if not isinstance(seed, torch.Generator):
      gen = torch.Generator(device=device)
      gen.manual_seed(int(seed))
    model = student_module(config, obs_dim).to(device)
    ppo.flax_init_(model, gen)
    if init_params is not None:
      eval_agent.load_mlp_params_(model, init_params)
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    env_state, ts = env.reset(gen)
    return DistillCarry(
        model, optimizer, env_state, ts, gen,
        torch.zeros((capacity, obs_dim), device=device),
        torch.zeros((capacity, config.action_dim), device=device))

  def collect(carry: DistillCarry, beta: float, mix) -> None:
    state, ts = carry.env_state, carry.ts
    obs_seq, act_seq = [], []
    with torch.no_grad():
      for t in range(config.rollout_length):
        obs = ts.observation
        teach = teacher(obs)
        student = carry.model(obs)
        u = (mix[t] if mix is not None else torch.rand(
            (obs.shape[0], 1), generator=carry.gen, device=device))
        action = torch.where(u < beta, teach, student)
        state, ts = env.step(state, action, carry.gen)
        obs_seq.append(obs)
        act_seq.append(teach)
    lo, hi = carry.filled, carry.filled + samples
    carry.buf_obs[lo:hi] = torch.stack(obs_seq).reshape(samples, obs_dim)
    carry.buf_act[lo:hi] = torch.stack(act_seq).reshape(
        samples, config.action_dim)
    carry.env_state, carry.ts, carry.filled = state, ts, hi

  def fit(carry: DistillCarry, indices) -> torch.Tensor:
    loss = None
    for s in range(config.sgd_steps_per_iteration):
      idx = (indices[s] if indices is not None else torch.randint(
          0, carry.filled, (config.minibatch_size,), generator=carry.gen,
          device=device))
      pred = carry.model(carry.buf_obs[idx])
      loss = torch.mean(torch.sum((pred - carry.buf_act[idx]) ** 2, dim=-1))
      carry.optimizer.zero_grad(set_to_none=True)
      loss.backward()
      carry.optimizer.step()
    return loss.detach()

  def run_iteration(carry: DistillCarry, beta: float, mix=None,
                    indices=None):
    collect(carry, beta, mix)
    return carry, {'loss': fit(carry, indices)}

  return init_carry, run_iteration


def distill(env, rate_fn: Optional[rates_lib.RateFunction],
            config: DistillConfig = DistillConfig(), seed: int = 0,
            progress=None, teacher=None):
  """Runs the whole DAgger loop; returns (student module, {'loss': list of
  floats, one per iteration})."""
  init_carry, run_iteration = make_distill_fns(env, rate_fn, config,
                                               teacher=teacher)
  carry = init_carry(seed)
  losses = []
  for i in range(config.num_iterations):
    beta = config.teacher_mix_init * config.teacher_mix_decay**i
    carry, metrics = run_iteration(carry, beta)
    loss = float(metrics['loss'])  # reads the device: the iteration is done
    losses.append(loss)
    if progress is not None:
      progress(i, {'loss': loss, 'beta': beta})
  return carry.model.eval(), {'loss': losses}


def train_and_save(env, workdir: str,
                   rate_fn: Optional[rates_lib.RateFunction],
                   config: DistillConfig = DistillConfig(), seed: int = 0,
                   progress=None, teacher=None) -> eval_agent.MLPPolicy:
  """Distills and saves an 'mlp' checkpoint (eval_agent.save_policy) that
  the registry's checkpoint entries of both packages load."""
  model, _ = distill(env, rate_fn, config, seed=seed, progress=progress,
                     teacher=teacher)
  eval_agent.save_policy(model, workdir)
  return model
