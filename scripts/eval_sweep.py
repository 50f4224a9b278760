"""Spread of a batched eval across seed suites (PyTorch port).

  python scripts/eval_sweep.py --experiment_name=ppo_simple_images_tf \
      --suites=10 [--device=cpu] [--image_size=128] [--package=jax]

Runs `--suites` suites of 100 seeds each (seeds 100k .. 100k+99) and
prints per suite the success rate and mean actions to goal, then the mean
and spread of the suite means and the mean over all episodes with its
standard error. Used to tell a port fault from the sampling spread of a
100-episode mean. --package=jax runs the same sweep through the JAX
package's batched evaluator on the CPU, for the comparison.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> None:
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--experiment_name', default='ppo_simple_images_tf')
  parser.add_argument('--suites', type=int, default=10)
  parser.add_argument('--device', default=None)
  parser.add_argument('--image_size', type=int, default=None)
  parser.add_argument('--package', choices=('torch', 'jax'), default='torch')
  args = parser.parse_args(argv)

  if args.package == 'jax':
    evaluate, device = _jax_evaluator(args), 'cpu (JAX package)'
  else:
    evaluate, device = _torch_evaluator(args)
  means, actions = [], []
  for k in range(args.suites):
    seeds = tuple(range(100 * k, 100 * k + 100))
    results = evaluate(seeds)
    done = [r.num_actions_taken for r in results if r.reached_goal]
    success = np.mean([r.reached_goal for r in results])
    means.append(np.mean(done))
    actions += done
    print(f'suite {k} (seeds {seeds[0]}-{seeds[-1]}): success {success}, '
          f'mean actions {np.mean(done)}', flush=True)
  a = np.asarray(actions)
  print(f'{args.experiment_name} on {device}: mean of suite means '
        f'{np.mean(means)}, SD of suite means {np.std(means)}; all '
        f'{len(a)} episodes: mean {a.mean()} +- {a.std() / np.sqrt(len(a))}'
        ' (SE)', flush=True)


def _torch_evaluator(args):
  from putting_dune_torch import device as device_lib
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  device = device_lib.resolve_device(args.device)
  exp = registry.create_eval_experiment(args.experiment_name)
  policy = exp.get_policy(exp.get_adapters_and_goal(), device)
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=100,
      image_size=args.image_size, device=device)
  # No wall-clock budget: a slow device must not truncate episodes.
  return (lambda seeds: eval_lib.evaluate_batched(
      env, policy, seeds, timeout_seconds=float('inf'))), device


def _jax_evaluator(args):
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  from putting_dune_tpu import eval as jax_eval_cli
  from putting_dune_tpu import eval_lib
  from putting_dune_tpu import run_helpers
  from putting_dune_tpu.experiments import registry

  exp = registry.create_eval_experiment(args.experiment_name)
  adapters = exp.get_adapters_and_goal()
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=100,
      image_size=args.image_size)
  policy = jax_eval_cli._policy_for_agent(  # pylint: disable=protected-access
      exp.get_agent(np.random.default_rng(0), adapters), env)
  return lambda seeds: eval_lib.evaluate_batched(
      env, policy, seeds, timeout_seconds=float('inf'))


if __name__ == '__main__':
  main()
