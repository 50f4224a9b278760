"""Where the PPO trainer's time goes, on one GPU.

  python scripts/profile_ppo.py [--configs=vector,pixel] [--updates=3]
      [--device=cuda]

Two configurations, at the widths `chip_smoke.py` phase 18 trains them:

  vector: `ppo_learned_2s` as runs/train_policies.sh trained it (batch
          1024, rollout 64, 4 epochs x 8 minibatches of 8192, hidden
          (256, 256), lr 3e-4);
  pixel:  `relative_simple_rates_from_images` as runs/train_pixels2.sh
          trained it (batch 256, 128^2 render, rollout 16, shaping 0.05,
          conv (16, 32, 64), hidden (256, 256): minibatches of 512 frames).

For each, after one warm-up update:

  1. plain: the host wall clock around each phase of `--updates` updates
     (synchronized): ms per rollout step (one env step at the whole batch
     and the policy's forward) and env steps per second, ms per gradient
     step (forward, backward, clipping and Adam on one minibatch) and
     gradient steps per second;
  2. torch.profiler over one rollout and over one update's gradient steps:
     the device busy share (summed kernel time / wall time), kernel launches
     per rollout step and per gradient step, and the largest kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

CONFIGS = {
    'vector': dict(experiment='ppo_learned_2s', batch=1024, rollout=64,
                   render=None, shaping=0.0),
    'pixel': dict(experiment='relative_simple_rates_from_images', batch=256,
                  rollout=16, render=128, shaping=0.05),
}


def _kernels(prof):
  overhead = ('Command Buffer Full', 'Buffer Flush',
              'Activity Buffer Request')
  return [e for e in prof.key_averages()
          if getattr(e, 'device_time_total', 0) > 0 and e.key
          and not e.key.startswith('aten::')
          and not e.key.startswith('cuda') and e.key not in overhead]


def profile(fn, steps, dev, label):
  """torch.profiler over fn(), which takes `steps` steps of one kind."""
  import torch
  from torch.profiler import ProfilerActivity, profile as torch_profile

  activities = [ProfilerActivity.CPU]
  if dev.type == 'cuda':
    activities.append(ProfilerActivity.CUDA)
  with torch_profile(activities=activities) as prof:
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  kernels = _kernels(prof)
  busy = sum(e.self_device_time_total for e in kernels) / 1e6
  launches = sum(e.count for e in kernels)
  print(f'  profiler, {label}: wall {wall / steps * 1e3:.4f} ms per step, '
        f'device busy {busy / steps * 1e3:.4f} ms per step, busy share '
        f'{busy / wall:.3f}, {launches / steps:.1f} kernel launches per '
        f'step', flush=True)
  kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
  for e in kernels[:10]:
    print(f'  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step '
          f'{e.count / steps:6.1f} calls/step  {e.key[:90]}', flush=True)
  return {'busy_share': busy / wall, 'launches_per_step': launches / steps,
          'wall_ms_per_step': wall / steps * 1e3}


def run(name, updates, dev):
  import torch

  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import ppo

  c = CONFIGS[name]
  exp = registry.create_train_experiment(c['experiment'])
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=c['batch'], image_size=c['render'], device=dev)
  config = ppo.PPOConfig(rollout_length=c['rollout'],
                         reward_shaping_coef=c['shaping'])
  trainer = ppo.PPOTrainer(env, config)
  carry = trainer.init_carry(0)
  grad_steps = config.num_epochs * config.num_minibatches

  def sync():
    if dev.type == 'cuda':
      torch.cuda.synchronize()

  traj, last = trainer.rollout(carry)  # warm-up
  trainer.learn(carry, traj, last)
  sync()
  t_roll, t_learn = 0.0, 0.0
  for _ in range(updates):
    t0 = time.perf_counter()
    traj, last = trainer.rollout(carry)
    sync()
    t1 = time.perf_counter()
    metrics = trainer.learn(carry, traj, last)
    sync()
    t_roll += t1 - t0
    t_learn += time.perf_counter() - t1
  roll_ms = t_roll / (updates * config.rollout_length) * 1e3
  grad_ms = t_learn / (updates * grad_steps) * 1e3
  print(f'{name}: {c["experiment"]}, batch {c["batch"]}, rollout '
        f'{config.rollout_length}, render {c["render"] or 512}, minibatch '
        f'{trainer.mb_size}, hidden {config.hidden}; {updates} updates on '
        f'{dev}', flush=True)
  print(f'  plain: {roll_ms:.4f} ms per rollout step '
        f'({c["batch"] * 1e3 / roll_ms:.1f} env steps/s), {grad_ms:.4f} ms '
        f'per gradient step ({1e3 / grad_ms:.1f} gradient steps/s), '
        f'{(t_roll + t_learn) / updates:.3f} s per update; last loss '
        f'{float(metrics["loss"]):.4f}', flush=True)
  out = {'rollout_ms_per_step': roll_ms, 'grad_ms_per_step': grad_ms}
  holder = {}

  def rollout():
    holder['traj'] = trainer.rollout(carry)

  out['rollout'] = profile(rollout, config.rollout_length, dev, 'rollout')
  out['learn'] = profile(lambda: trainer.learn(carry, *holder['traj']),
                         grad_steps, dev, 'gradient steps')
  return out


def main(argv=None) -> dict:
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, root)
  import torch

  from putting_dune_torch import device as device_lib

  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--configs', default='vector,pixel')
  parser.add_argument('--updates', type=int, default=3)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  dev = device_lib.resolve_device(args.device)
  if dev.type == 'cuda':
    torch.backends.cuda.matmul.allow_tf32 = False
  return {name: run(name, args.updates, dev)
          for name in args.configs.split(',')}


if __name__ == '__main__':
  main()
