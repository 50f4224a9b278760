"""Traffic kind `batched_eval`: whole calls of the batched evaluator.

The window is a sequence of `eval_lib.evaluate_batched` calls on the
traffic's suite (seeds `suite_start` .. `suite_start + batch - 1`, as the
eval CLI's suites are fixed ranges), through the env and policy the eval
CLI builds (`run_helpers.create_batched_env`,
`registry.create_eval_experiment`, `eval.policy_for_agent`). Every run
does the same work whatever its seed; the seed picks the loop steps the
check records. The window ends with the first call that ends after the
window's seconds, and holds at least `min_calls` calls.

End-to-end: `env_steps_per_s`, the sum of `num_actions_taken` over every
episode the window's calls returned, over the window's seconds.

The benchmark's probes sit around the calls into the program: a proxy of
the env whose `reset` and `step` open `bench.env_reset` / `bench.env_step`
spans, a wrapper of the policy (`bench.policy`) that counts loop steps,
and recorders of what the timed path produced:

- at the first call's reset and at a few loop steps drawn from the seed:
  the state before and after the step, the action, its timestep, the
  noise chain's draws (the seeds the renderer draws, or the CPU path's
  uniforms), the KMC's uniforms and every rate call, the policy's input
  and action and, for the vision planner, the detector's logits;
- over the whole first call: each step's step type, discount and
  simulated seconds, the host's clock around each step, and the
  episodes' results, for the replay of the evaluator's accounting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode


class _DrawRecorder(TorchFunctionMode):
  """Keeps the outputs of `torch.randint` and `torch.rand` calls that
  draw from a generator; changes nothing. The first `torch.rand` after a
  KMC rate call is that round's uniforms (`kmc`)."""

  def __init__(self):
    super().__init__()
    self.randint, self.rand, self.kmc = [], [], []
    self.after_rates = False

  def __torch_function__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    if kwargs.get('generator') is not None:
      if func is torch.randint:
        self.randint.append(out)
      elif func is torch.rand:
        if self.after_rates:
          self.kmc.append(out.clone())
          self.after_rates = False
        else:
          self.rand.append(out)
    return out


def _span(name: str, on: bool):
  return (torch.profiler.record_function(name) if on
          else contextlib.nullcontext())


@dataclasses.dataclass
class Counters:
  calls: int = 0
  policy_calls: int = 0
  env_steps: int = 0
  episodes: int = 0
  live_steps: int = 0

  def clear(self) -> None:
    for field in dataclasses.fields(self):
      setattr(self, field.name, 0)


class _Probe:
  """Which (call, step) pairs are recorded, and what was recorded."""

  def __init__(self, seed: int, samples: int, within: int):
    rng = np.random.default_rng([seed, 7])
    steps = rng.choice(within, size=samples, replace=False)
    # Half the samples in the first call, the rest in the second.
    self.wanted = {(i % 2, int(s)) for i, s in enumerate(steps)}
    self.call = -1
    self.step = 0
    self.records = {}
    self.episodes = None
    self.enabled = True

  def active(self) -> bool:
    return self.enabled and (self.call, self.step) in self.wanted

  def accounting(self) -> bool:
    return self.enabled and self.call == 0

  def record(self, key: str, value) -> None:
    self.records.setdefault((self.call, self.step), {})[key] = value


def _clone(tree):
  if isinstance(tree, dict):
    return {k: _clone(v) for k, v in tree.items()}
  return tree.detach().clone()


def _before(state) -> dict:
  """What the step starts from: pose, silicon, field of view, drift, goal
  and the episode's counters."""
  sim = state.sim
  return _clone({
      'offset': sim.material.offset, 'theta': sim.material.theta,
      'si_index': sim.material.si_index, 'lower_left': sim.fov.lower_left,
      'upper_right': sim.fov.upper_right, 'drift': sim.drift,
      'goal': state.goal.position_material,
      'goal_steps': state.goal.consecutive_goal_steps,
      'step_count': state.step_count, 'needs_reset': state.needs_reset})


def _timestep(ts) -> dict:
  return _clone({'step_type': ts.step_type, 'reward': ts.reward,
                 'discount': ts.discount,
                 'elapsed_seconds': ts.elapsed_seconds})


class EnvProxy:
  """The env as the evaluator sees it, with the benchmark's spans and
  recorders around `reset` and `step`."""

  def __init__(self, env, probe: _Probe, counters: Counters):
    self._env = env
    self._probe = probe
    self._counters = counters
    self.spans = False
    self.on_step = None

  def __getattr__(self, name):
    return getattr(self._env, name)

  def reset(self, gen):
    probe = self._probe
    probe.call += 1
    if not (probe.enabled and probe.call == 0):
      probe.step = 0
      with _span('bench.env_reset', self.spans):
        return self._env.reset(gen)
    # The first call's reset: the start of every episode of the suite.
    probe.step = -1
    draws = _DrawRecorder()
    with _span('bench.env_reset', self.spans), draws:
      state, ts = self._env.reset(gen)
    self._record(state, ts, draws, [])
    probe.step = 0
    probe.episodes = {'reset_elapsed': ts.elapsed_seconds.clone(),
                      'steps': [], 'reset_exit': time.perf_counter()}
    return state, ts

  def step(self, state, action, gen):
    probe = self._probe
    entry = time.perf_counter()
    if not probe.active():
      with _span('bench.env_step', self.spans):
        out = self._env.step(state, action, gen)
    else:
      out = self._recorded_step(state, action, gen)
    if probe.accounting():
      ts = out[1]
      probe.episodes['steps'].append(
          (ts.step_type.clone(), ts.discount.clone(),
           ts.elapsed_seconds.clone(), entry, time.perf_counter()))
    self._counters.env_steps += 1
    probe.step += 1
    if self.on_step is not None:
      self.on_step(self._counters.env_steps)
    return out

  def _recorded_step(self, state, action, gen):
    env = self._env
    rate_fn = env.rate_fn
    calls = []
    draws = _DrawRecorder()

    def recording_rate_fn(si_pos, nbr_pos, beam_pos):
      rates = rate_fn(si_pos, nbr_pos, beam_pos)
      calls.append((nbr_pos.clone(), beam_pos.clone(), rates.clone()))
      draws.after_rates = True
      return rates

    before = _before(state)
    action_in = action.detach().clone()
    env.rate_fn = recording_rate_fn
    try:
      with _span('bench.env_step', self.spans), draws:
        new_state, ts = env.step(state, action, gen)
    finally:
      env.rate_fn = rate_fn
    self._record(new_state, ts, draws, calls)
    self._probe.record('transition', {
        'before': before, 'action': action_in, 'kmc_uniforms': draws.kmc,
        'timestep': _timestep(ts)})
    return new_state, ts

  def _record(self, new_state, ts, draws, calls):
    sim = new_state.sim
    scene = {
        'offset': sim.material.offset, 'theta': sim.material.theta,
        'si_index': sim.material.si_index, 'lower_left': sim.fov.lower_left,
        'upper_right': sim.fov.upper_right, 'drift': sim.drift,
        **dataclasses.asdict(sim.imaging)}
    scene = _clone(scene)
    if draws.randint:
      scene['seeds'] = draws.randint[-1].clone()
    uniforms = [u for u in draws.rand if u.dim() >= 2]
    if uniforms:
      scene['uniforms'] = [u.clone() for u in uniforms]
    self._probe.record('scene', scene)
    self._probe.record('observation', _clone(ts.observation))
    self._probe.record('rate_calls', calls)


class PolicyProbe:
  """The policy as the evaluator sees it: counts loop steps, opens the
  `bench.policy` span and records input and action at sampled steps."""

  def __init__(self, policy, agent, probe: _Probe, counters: Counters):
    self._policy = policy
    self._agent = agent
    self._probe = probe
    self._counters = counters
    self.spans = False

  def __call__(self, gen, obs):
    self._counters.policy_calls += 1
    if not self._probe.active():
      with _span('bench.policy', self.spans):
        return self._policy(gen, obs)
    detector = getattr(self._agent, '_detector_fn', None)
    logits = []
    if detector is not None:
      def recording_detector(image):
        out = detector(image)
        logits.append(out.clone())
        return out
      self._agent._detector_fn = recording_detector
    try:
      with _span('bench.policy', self.spans):
        action = self._policy(gen, obs)
    finally:
      if detector is not None:
        self._agent._detector_fn = detector
    self._probe.record('policy_input', _clone(obs))
    self._probe.record('action', action.clone())
    if logits:
      self._probe.record('logits', logits[0])
    return action


class Session:
  """One cell's program, built once in set-up and driven by the window."""

  def __init__(self, cell, seed: int, device):
    from putting_dune_torch import eval as eval_cli
    from putting_dune_torch import registry
    from putting_dune_torch import run_helpers

    config, traffic = cell.config, cell.traffic
    self.config, self.traffic, self.root = config, traffic, cell.root
    self.device = torch.device(device)
    self.batch = int(traffic['batch'])
    self.counters = Counters()
    self.probe = _Probe(seed, int(traffic['recorded_steps']),
                        int(traffic['record_within']))
    experiment = registry.create_eval_experiment(config['experiment'])
    adapters = experiment.get_adapters_and_goal()
    agent = experiment.get_policy(adapters, self.device)
    env = run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=self.batch, step_limit=int(config['env']['step_limit']),
        grid_columns=int(config['env']['grid_columns']),
        image_size=int(traffic['render_size']), device=self.device)
    self.env = EnvProxy(env, self.probe, self.counters)
    self.policy = PolicyProbe(eval_cli.policy_for_agent(agent), agent,
                              self.probe, self.counters)
    start = int(traffic['suite_start'])
    self.suite = list(range(start, start + self.batch))

  def _evaluate(self, max_steps=None):
    from putting_dune_torch import eval_lib

    return eval_lib.evaluate_batched(
        self.env, self.policy, self.suite,
        timeout_seconds=float(self.traffic['timeout_seconds']),
        max_steps=max_steps or self.traffic.get('max_steps'),
        chunk_steps=int(self.traffic['chunk_steps']))

  def warm_up(self) -> None:
    """The suite's first `warm_up_steps` loop steps at the cell's batch:
    every kernel, the auto-reset's shapes and the host paths the window
    takes. Nothing of it is counted or recorded."""
    self.probe.enabled = False
    self._evaluate(int(self.traffic['warm_up_steps']))
    self.probe.enabled = True
    self.probe.call = -1
    self.counters.clear()
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def run_window(self, seconds: float, profiler=None) -> dict:
    """Whole evaluator calls until one ends after `seconds` (and at least
    `min_calls`). With `profiler`, its first `traced_steps` env steps
    are traced inside a `bench.window` span.

    Returns the window's seconds, the episodes attempted and failed, the
    end-to-end values by metric name and a summary for the log."""
    self.env.spans = self.policy.spans = profiler is not None
    traced = {}
    if profiler is not None:
      limit = int(self.traffic['traced_steps'])
      window = torch.profiler.record_function('bench.window')

      def on_step(n):
        if n == limit:
          if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
          window.__exit__(None, None, None)
          profiler.stop()
          traced['seconds'] = time.perf_counter() - traced['start']
          traced['steps'] = n
          self.env.on_step = None
          self.env.spans = self.policy.spans = False

      self.env.on_step = on_step
      profiler.start()
      window.__enter__()
      traced['start'] = time.perf_counter()
    start = time.perf_counter()
    calls = []
    while True:
      t0 = time.perf_counter()
      results = self._evaluate()
      calls.append(time.perf_counter() - t0)
      if self.counters.calls == 0 and self.probe.episodes is not None:
        self.probe.episodes['results'] = [
            (r.num_actions_taken, r.reached_goal) for r in results]
      self.counters.calls += 1
      self.counters.episodes += len(results)
      self.counters.live_steps += sum(r.num_actions_taken for r in results)
      elapsed = time.perf_counter() - start
      if elapsed >= seconds and len(calls) >= int(self.traffic['min_calls']):
        break
    if 'seconds' not in traced and profiler is not None:
      raise RuntimeError('the traced steps outlasted the window')
    c = self.counters
    summary = (f'{c.calls} calls, {c.policy_calls} loop steps, {c.episodes} '
               f'episodes, {c.live_steps} live env steps; seconds a call '
               f'{calls}')
    if traced:
      summary += (f'; {traced["steps"]} env steps traced in '
                  f'{traced["seconds"]} s')
    return {'seconds': elapsed, 'attempted': c.episodes, 'failed': 0,
            'end_to_end': {'env_steps_per_s': c.live_steps / elapsed},
            'summary': summary}

  def reseed(self, seed: int) -> None:
    """Another seed's recorded steps on the same program (calibration
    only)."""
    self.probe = _Probe(seed, int(self.traffic['recorded_steps']),
                        int(self.traffic['record_within']))
    self.env._probe = self.policy._probe = self.probe
    self.counters.clear()

  def release(self) -> None:
    """Drops the program's state (env, policy, agent) before the check."""
    self.env = self.policy = None
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def samples(self) -> list:
    """The first call's reset (the scene, its observation), the recorded
    steps (each with the state before and after its env step, the
    action, the KMC's uniforms and rate calls, the observation, the
    policy's input, action and logits), and the first call's accounting
    (`episodes`)."""
    out = [self.probe.records[k] for k in sorted(self.probe.records)]
    if self.probe.episodes is not None and 'results' in self.probe.episodes:
      out.append({'episodes': self.probe.episodes})
    return out

  def expected_samples(self) -> int:
    return 2 + int(self.traffic['recorded_steps'])

  def trace_context(self, samples) -> dict:
    """What this kind's per-layer readers read besides the trace: the
    counters, the batch, the render's shape and its share of small
    Poisson means, the policy's FLOPs a loop step and the peak."""
    from benchmark.checks import render
    from benchmark.lib import cells
    from benchmark.lib import peaks

    size = int(self.traffic['render_size'])
    model = self.config['model']
    per_frame = cells.load_module('models', model['kind'],
                                  self.root).flops(model)
    return {
        'counters': dataclasses.asdict(self.counters), 'batch': self.batch,
        'render_shape': (self.batch, size, size),
        'small_lambda_share': render.small_lambda_share(
            samples, self.config, self.traffic),
        'flops_per_step': float(per_frame) * self.batch,
        'peak_flops': peaks.PEAK_FLOPS[self.config['peak']]}


def setup(cell, seed: int, device) -> Session:
  t0 = time.perf_counter()
  session = Session(cell, seed, device)
  t1 = time.perf_counter()
  session.warm_up()
  session.setup_seconds = {'build': t1 - t0,
                           'warm_up': time.perf_counter() - t1}
  return session
