"""Where an env step's time goes: an image-observation eval loop on one GPU.

  python scripts/profile_eval_step.py [--batch=100] [--steps=30]
      [--experiment_name=vision_planner_simple_rates]

Runs the experiment (default `ppo_simple_images_tf`, at the 512^2 render;
a multi-dopant name such as `multi_dopant_3_vision_planner` or
`multi_dopant_3_planner` runs the D-dopant env at its own frame size; a
drift-corrected one carries its policy state as the eval loop does) for
--steps env steps after a warm-up, three ways:

  1. plain: host wall clock per step (policy + env.step), synchronized;
  2. sections: the same loop with the KMC, the render (splat + noise +
     CLAHE), the atom window, the policy and, inside it, the drift
     corrector's phase correlation and the planner's rate model (the
     learned one of `planner_learned_rates` and
     `vision_planner_learned_rates`, or an analytic law) wrapped in
     synchronized timers (the synchronizes add host time; the split is
     what counts);
  3. torch.profiler over the plain loop: device time by kernel name, the
     device busy share (summed kernel time / wall time) and the FFT
     kernels' share of the device time.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time


def main(argv=None) -> None:
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import kmc
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch import simulator
  from putting_dune_torch.agents import drift_correction
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.imaging import render

  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--batch', type=int, default=100)
  parser.add_argument('--steps', type=int, default=30)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--experiment_name', default='ppo_simple_images_tf')
  args = parser.parse_args(argv)

  dev = torch.device(args.device)

  def sync():
    if dev.type == 'cuda':
      torch.cuda.synchronize()
  multi = args.experiment_name in registry.multi_dopant_experiment_names()
  agent = None
  if multi:
    env, policy = eval_cli._multi_dopant_env_and_policy(
        eval_cli.Args(experiment_name=args.experiment_name), args.batch, dev)
  else:
    exp = registry.create_eval_experiment(args.experiment_name)
    agent = exp.get_policy(exp.get_adapters_and_goal(), dev)
    policy = eval_cli.policy_for_agent(agent)
    env = run_helpers.create_batched_env(
        exp.get_adapters_and_goal, exp.get_simulator_config,
        batch_size=args.batch, device=dev)
  gen = env_lib.make_generator(0, dev)
  carry = {}

  def act(ts):
    carry['pstate'], action = carry['step'](carry['pstate'], gen,
                                            ts.observation, ts.first())
    return action

  def run(n, state, ts):
    for _ in range(n):
      state, ts = env.step(state, act(ts), gen)
    return state, ts

  with torch.inference_mode():
    state, ts = env.reset(gen)
    carry['pstate'], carry['step'] = eval_lib.policy_stepper(
        policy, ts.observation)
    state, ts = run(5, state, ts)  # warm-up
    sync()

    t0 = time.perf_counter()
    state, ts = run(args.steps, state, ts)
    sync()
    plain = (time.perf_counter() - t0) / args.steps
    print(f'{args.experiment_name} plain: {plain * 1e3:.3f} ms per env step '
          f'at batch {args.batch} '
          f'({args.batch / plain:.1f} env steps/s)', flush=True)

    totals = collections.Counter()
    counts = collections.Counter()

    def timed(name, fn):
      def wrapper(*a, **k):
        sync()
        t = time.perf_counter()
        out = fn(*a, **k)
        sync()
        totals[name] += time.perf_counter() - t
        counts[name] += 1
        return out
      return wrapper

    # Both envs reach these through the modules' attributes; the D-dopant
    # env's atom window is a method.
    originals = (kmc.apply_control, kmc.apply_control_multi,
                 render.render_stem_image, simulator.atom_window,
                 drift_correction.estimate_content_shift_px)
    drift_correction.estimate_content_shift_px = timed(
        'phase correlation', drift_correction.estimate_content_shift_px)
    kmc.apply_control = timed('kmc', kmc.apply_control)
    kmc.apply_control_multi = timed('kmc', kmc.apply_control_multi)
    render.render_stem_image = timed('render', render.render_stem_image)
    simulator.atom_window = timed('atom_window', simulator.atom_window)
    if multi:
      env._atom_window = timed('atom_window', env._atom_window)
    # The planners read their rate model when they act.
    rate_model = getattr(agent, 'rate_fn', None)
    if rate_model is not None:
      agent.rate_fn = timed('rate model', rate_model)
    timed_act = timed('policy', act)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
      action = timed_act(ts)
      state, ts = timed('env.step', env.step)(state, action, gen)
    sync()
    total = time.perf_counter() - t0
    (kmc.apply_control, kmc.apply_control_multi, render.render_stem_image,
     simulator.atom_window,
     drift_correction.estimate_content_shift_px) = originals
    if multi:
      del env._atom_window
    if rate_model is not None:
      agent.rate_fn = rate_model
    print(f'sections (synchronized), per env step, total '
          f'{total / args.steps * 1e3:.3f} ms:', flush=True)
    for name in ('policy', 'phase correlation', 'rate model', 'env.step',
                 'kmc', 'render', 'atom_window'):
      print(f'  {name}: {totals[name] / args.steps * 1e3:.3f} ms '
            f'({counts[name]} calls)', flush=True)

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
      activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
      sync()
      t0 = time.perf_counter()
      state, ts = run(args.steps, state, ts)
      sync()
      wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_time_total', 0) > 0]
    # Kernels only: top-level ops also report their kernels' device time.
    # The profiler's own buffer events are no kernels either.
    overhead = ('Command Buffer Full', 'Buffer Flush',
                'Activity Buffer Request')
    kernels = [e for e in events if e.key and not e.key.startswith('aten::')
               and not e.key.startswith('cuda') and e.key not in overhead]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    fft_kernels = [e for e in kernels if 'fft' in e.key.lower()]
    fft = sum(e.self_device_time_total for e in fft_kernels) / 1e6
    print(f'profiler: wall {wall / args.steps * 1e3:.3f} ms per step, '
          f'device busy {busy / args.steps * 1e3:.3f} ms per step, '
          f'busy share {busy / wall:.3f}; FFT kernels '
          f'{fft / args.steps * 1e3:.4f} ms per step, '
          f'{fft / max(busy, 1e-12):.4f} of the device time', flush=True)
    for e in fft_kernels:
      print(f'  FFT kernel: {e.self_device_time_total / args.steps:.3f} us/step '
            f'{e.count / args.steps:.1f} calls/step  {e.key[:90]}', flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:25]:
      print(f'  {e.self_device_time_total / 1e3 / args.steps:9.4f} ms/step '
            f'{e.count / args.steps:7.1f} calls/step  {e.key[:90]}',
            flush=True)


if __name__ == '__main__':
  main()
