"""One eval through both packages on the CPU, on the same seeds.

  python scripts/eval_cpu_pair.py --experiment_name=multi_dopant_3_vision_planner \
      [--seeds=0-19] [--step_limit=600] [--out_dir=runs/eval_pair] \
      [--grid_columns=50] [--batch_size=20]

The experiment is a multi-dopant one or a single-dopant eval experiment of
both registries (`vision_planner_drift_corrected`, say; the single-dopant
env renders at its default 512^2, on a lattice of `--grid_columns`).

Runs the JAX package's and the PyTorch port's `evaluate_batched` on the CPU,
at the same time, each in a process of its own (`--worker=jax|torch`; the
JAX one with JAX_PLATFORMS=cpu, as the JAX package's tests run it). Both see
the same seed list (`--seeds`: `a-b`, both ends included, or a comma list;
the suite names of eval_lib, such as `small_eval`, work too) in consecutive
batches of `--batch_size` seeds, each an `evaluate_batched` call of its own:
a JAX batch of 100 pixel envs at 512^2 holds ~38 GB on the CPU, one of 20
~9 GB (vector envs take batches of 1000). The PRNG streams differ (threefry against Philox), so the two runs
draw different episodes from the same laws.

The evaluators' budget is simulated seconds plus the batch's wall clock
(600 s). A CPU takes seconds a step where the card takes milliseconds, so
each worker runs its evaluator with a clock that stands still: only the
simulated seconds count, as on a card whose wall clock is a small part of
the budget. Each worker writes its per-episode results and seconds per step
as JSON under `--out_dir`; the parent prints, for each package, the success
rate with its binomial standard error and the average actions to goal (over
the episodes that reached it) with its standard error, then the two-sided z
of the success difference and of the actions difference. The report always
pairs the two workers of one invocation.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_SIZE = 20


def parse_seeds(text: str):
  """`a-b` (both ends included), `a,b,c`, or a suite name of eval_lib."""
  if text.endswith('_eval'):
    sys.path.insert(0, ROOT)
    from putting_dune_torch import eval_lib

    return eval_lib.EVAL_SUITES[text]
  if '-' in text:
    lo, hi = text.split('-')
    return tuple(range(int(lo), int(hi) + 1))
  return tuple(int(s) for s in text.split(','))


def _stopped_clock(eval_lib) -> None:
  """The evaluator's wall clock stands still (see the module docstring)."""
  eval_lib.time = types.SimpleNamespace(perf_counter=lambda: 0.0)


def _jax_results(experiment_name, seeds, step_limit, grid_columns):
  import numpy as np

  from putting_dune_tpu import eval as eval_cli
  from putting_dune_tpu import eval_lib
  from putting_dune_tpu import run_helpers
  from putting_dune_tpu.experiments import registry

  _stopped_clock(eval_lib)
  if experiment_name in registry.multi_dopant_experiment_names():
    experiment = registry.create_multi_dopant_experiment(experiment_name)
    env = experiment.make_env(len(seeds), step_limit=step_limit)
    policy = experiment.get_agent(None, None).policy()
  else:
    experiment = registry.create_eval_experiment(experiment_name)
    agent = experiment.get_agent(np.random.default_rng(0),
                                 experiment.get_adapters_and_goal())
    env = run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=len(seeds), step_limit=step_limit,
        grid_columns=grid_columns)
    policy = eval_cli._policy_for_agent(agent, env)  # pylint: disable=protected-access
  return eval_lib.evaluate_batched(env, policy, seeds)


def _torch_results(experiment_name, seeds, step_limit, grid_columns):
  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  _stopped_clock(eval_lib)
  if experiment_name in registry.multi_dopant_experiment_names():
    experiment = registry.create_multi_dopant_experiment(experiment_name)
    env = experiment.make_env(len(seeds), step_limit=step_limit,
                              device='cpu')
    policy = eval_cli.policy_for_agent(experiment.get_agent(env.device))
  else:
    experiment = registry.create_eval_experiment(experiment_name)
    adapters_and_goal = experiment.get_adapters_and_goal()
    env = run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=len(seeds), step_limit=step_limit,
        grid_columns=grid_columns, device='cpu')
    policy = eval_cli.policy_for_agent(
        experiment.get_policy(adapters_and_goal, env.device))
  return eval_lib.evaluate_batched(env, policy, seeds)


def worker(package, experiment_name, seeds, step_limit, out_path,
           grid_columns=50, batch_size=BATCH_SIZE) -> None:
  t0 = time.perf_counter()
  run = _jax_results if package == 'jax' else _torch_results
  results, steps = [], 0
  for i in range(0, len(seeds), batch_size):
    batch = run(experiment_name, seeds[i:i + batch_size], step_limit,
                grid_columns)
    results += batch
    steps += max(r.num_actions_taken for r in batch)
  seconds = time.perf_counter() - t0
  with open(out_path, 'w') as f:
    json.dump({
        'package': package,
        'seeds': list(seeds),
        'seconds': seconds,
        'batched_steps': steps,
        'results': [{'seed': int(r.seed), 'reached_goal': bool(r.reached_goal),
                     'num_actions_taken': int(r.num_actions_taken)}
                    for r in results],
    }, f)


def summary(results):
  """Success with its binomial SE; actions over reached with their SE."""
  n = len(results)
  done = [r['num_actions_taken'] for r in results if r['reached_goal']]
  p = len(done) / n
  k = len(done)
  mean = sum(done) / k if k else float('nan')
  sd = (math.sqrt(sum((a - mean) ** 2 for a in done) / (k - 1))
        if k > 1 else float('nan'))
  return {'episodes': n, 'success': p,
          'success_se': math.sqrt(p * (1 - p) / n),
          'average_actions': mean,
          'average_actions_se': sd / math.sqrt(k) if k else float('nan')}


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--experiment_name',
                      default='multi_dopant_3_vision_planner')
  parser.add_argument('--seeds', default='0-19')
  parser.add_argument('--step_limit', type=int, default=600)
  parser.add_argument('--grid_columns', type=int, default=50)
  parser.add_argument('--batch_size', type=int, default=BATCH_SIZE)
  parser.add_argument('--out_dir', default=os.path.join(
      ROOT, 'runs', 'eval_pair'))
  parser.add_argument('--worker', choices=('jax', 'torch'), default=None)
  args = parser.parse_args(argv)
  seeds = parse_seeds(args.seeds)
  os.makedirs(args.out_dir, exist_ok=True)

  def out_path(package):
    return os.path.join(args.out_dir,
                        f'{args.experiment_name}_{package}.json')

  if args.worker:
    sys.path.insert(0, ROOT)
    worker(args.worker, args.experiment_name, seeds, args.step_limit,
           out_path(args.worker), args.grid_columns, args.batch_size)
    return

  workers = {}
  for package in ('jax', 'torch'):
    if os.path.exists(out_path(package)):
      os.remove(out_path(package))
    env = dict(os.environ, PYTHONPATH=ROOT)
    if package == 'jax':
      env['JAX_PLATFORMS'] = 'cpu'
    workers[package] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f'--worker={package}',
         f'--experiment_name={args.experiment_name}', f'--seeds={args.seeds}',
         f'--step_limit={args.step_limit}', f'--out_dir={args.out_dir}',
         f'--grid_columns={args.grid_columns}',
         f'--batch_size={args.batch_size}'],
        env=env)
  failed = [p for p, w in workers.items() if w.wait() != 0]
  if failed:
    sys.exit(f'worker(s) {failed} failed')
  report = {'experiment': args.experiment_name, 'seeds': args.seeds,
            'grid_columns': args.grid_columns}
  for package in ('jax', 'torch'):
    with open(out_path(package)) as f:
      run = json.load(f)
    report[package] = dict(summary(run['results']), seconds=run['seconds'],
                           batched_steps=run['batched_steps'])
    print(json.dumps({package: report[package]}), flush=True)
  a, b = report['jax'], report['torch']
  se = math.hypot(a['success_se'], b['success_se'])
  report['success_z'] = ((b['success'] - a['success']) / se if se > 0
                         else 0.0)
  se = math.hypot(a['average_actions_se'], b['average_actions_se'])
  report['actions_z'] = ((b['average_actions'] - a['average_actions']) / se
                         if se > 0 else 0.0)
  print(json.dumps(report), flush=True)


if __name__ == '__main__':
  main()
