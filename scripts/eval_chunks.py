"""The batched evaluator's chunking on the card, three ways in one process.

  python scripts/eval_chunks.py [--experiments=ppo_simple_images_tf,vision_planner_simple_rates]
      [--seeds=small_eval] [--repeats=2]

For each experiment, `eval_lib.evaluate_batched` runs the suite as one
batch in three variants:

  chunk_1           chunk_steps=1: the host reads "all done" (and the wall
                    clock) after every step, a sync a step;
  chunk_64_no_poll  chunk_steps=64 with the in-chunk poll switched off:
                    "all done" is read only between chunks, so up to 63
                    masked steps run after the last episode ends;
  chunk_64          the default: chunk_steps=64, and inside a chunk the
                    loop stops once an earlier step's "all done", copied to
                    the host without a sync, reads true.

The variants run in the order a b c c b a, `--repeats` times, after one
untimed run that warms the caches. Each run builds its env first (not
timed), then times `evaluate_batched` to a device synchronize. Printed per
run: the wall seconds, the env steps the loop ran (env.step calls), the
useful env steps (batch x the longest episode, the eval CLI's count), env
steps/s from the useful ones, and whether the results equal the first
run's; then each variant's median seconds and env steps/s. The first line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ('chunk_1', 'chunk_64_no_poll', 'chunk_64')


def _key(results):
  return [tuple('nan' if isinstance(v, float) and v != v else v
                for v in (r.seed, r.reached_goal, r.num_actions_taken,
                          r.environment_seconds_to_goal, r.total_reward))
          for r in results]


def run(experiment, seeds, variant, device):
  import torch

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  exp = registry.create_eval_experiment(experiment)
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(seeds), device=device)
  policy = eval_cli.policy_for_agent(
      exp.get_policy(exp.get_adapters_and_goal(), device))
  step = env.step
  count = [0]

  def counted_step(*args, **kwargs):
    count[0] += 1
    return step(*args, **kwargs)

  env.step = counted_step
  poll = eval_lib._DonePoll.all_done  # pylint: disable=protected-access
  if variant == 'chunk_64_no_poll':
    eval_lib._DonePoll.all_done = lambda self, done: False  # pylint: disable=protected-access
  sync = (torch.cuda.synchronize if device.type == 'cuda'
          else lambda: None)
  try:
    sync()
    t0 = time.perf_counter()
    results = eval_lib.evaluate_batched(
        env, policy, seeds, chunk_steps=1 if variant == 'chunk_1' else 64)
    sync()
    seconds = time.perf_counter() - t0
  finally:
    eval_lib._DonePoll.all_done = poll  # pylint: disable=protected-access
  useful = len(seeds) * max(r.num_actions_taken for r in results)
  return results, dict(seconds=seconds, loop_steps=count[0],
                       useful_env_steps=useful,
                       env_steps_per_s=useful / seconds)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--experiments',
                      default='ppo_simple_images_tf,vision_planner_simple_rates')
  parser.add_argument('--seeds', default='small_eval')
  parser.add_argument('--repeats', type=int, default=2)
  args = parser.parse_args(argv)
  sys.path.insert(0, ROOT)
  import torch

  from putting_dune_torch import eval_lib
  from putting_dune_torch.ops import _build

  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi, flush=True)
  _build.build_all()
  device = torch.device('cuda')
  seeds = list(eval_lib.EVAL_SUITES[args.seeds])
  order = list(VARIANTS) + list(reversed(VARIANTS))
  for experiment in args.experiments.split(','):
    reference, _ = run(experiment, seeds, 'chunk_1', device)
    reading = {v: [] for v in VARIANTS}
    for _ in range(args.repeats):
      for variant in order:
        results, row = run(experiment, seeds, variant, device)
        row.update(experiment=experiment, variant=variant,
                   same_results=_key(results) == _key(reference))
        reading[variant].append(row)
        print(json.dumps(row), flush=True)
    for variant, rows in reading.items():
      print(json.dumps({
          'experiment': experiment, 'variant': variant, 'runs': len(rows),
          'median_seconds': statistics.median(r['seconds'] for r in rows),
          'median_env_steps_per_s': statistics.median(
              r['env_steps_per_s'] for r in rows),
          'loop_steps': sorted({r['loop_steps'] for r in rows}),
          'all_same_results': all(r['same_results'] for r in rows),
          'card': smi}), flush=True)


if __name__ == '__main__':
  main()
