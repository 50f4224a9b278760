"""PPO from several seeds, in either package: how often and how far a
configuration learns.

  python scripts/train_seeds.py --package=torch|jax \
      [--train_experiment=ppo_learned_2s] [--batch_size=1024] \
      [--rollout_length=64] [--num_updates=50] [--seeds=0,1,2] \
      [--eval_suite=small_eval] [--device=cuda] [--out=runs/seeds.json]

For each seed: the package's trainer (`make_train`) at the given widths
(hidden (256, 256), 4 epochs x 8 minibatches, lr 3e-4: the PPOConfig
defaults, as runs/train_policies.sh ran them), then the trained policy
(the port's `ppo.as_policy`, the JAX package's `as_eval_agent`) on the
eval suite through the package's `evaluate_batched`. Prints and writes,
per seed, the training seconds, the mean terminal rate over updates 0-9
and 40-49 (or the last ten), the success and the average actions to goal,
then the means over seeds with their standard errors.

`--package=jax` runs the JAX package on the CPU (JAX_PLATFORMS=cpu) with
the evaluator's clock stood still, so that only simulated seconds count
as on a card; `--package=torch` runs the port on `--device` (CUDA unless
asked for the CPU). `chip_smoke.py` phase 18a sets its bars from this
script's JAX runs; the port imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mean_se(values):
  n = len(values)
  mean = sum(values) / n
  if n < 2:
    return mean, float('nan')
  var = sum((v - mean) ** 2 for v in values) / (n - 1)
  return mean, math.sqrt(var / n)


def _jax_runs(args, seeds):
  """(seed, train seconds, terminal rates, loss, success, actions) rows."""
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  import jax
  import numpy as np

  from putting_dune_tpu import eval_lib
  from putting_dune_tpu import run_helpers
  from putting_dune_tpu.agents import ppo
  from putting_dune_tpu.experiments import registry

  eval_lib.time = types.SimpleNamespace(perf_counter=lambda: 0.0)
  exp = registry.create_train_experiment(args.train_experiment)
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=args.batch_size)
  config = ppo.PPOConfig(num_updates=args.num_updates,
                         rollout_length=args.rollout_length)
  train, _ = ppo.make_train(env, config)
  suite = eval_lib.EVAL_SUITES[args.eval_suite]
  eval_env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(suite))
  for seed in seeds:
    t0 = time.perf_counter()
    params, metrics = train(jax.random.PRNGKey(seed))
    rate = np.asarray(metrics['terminal_rate'])
    seconds = time.perf_counter() - t0
    agent = ppo.as_eval_agent(params, env, config)
    agg = eval_lib.aggregate_results(
        eval_lib.evaluate_batched(eval_env, agent.policy(), suite))
    yield (seed, seconds, rate, np.asarray(metrics['loss']),
           agg.average_num_times_reached_goal, agg.average_num_actions_taken)


def _torch_runs(args, seeds):
  import torch

  from putting_dune_torch import device as device_lib
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.agents import ppo

  dev = device_lib.resolve_device(args.device)
  exp = registry.create_train_experiment(args.train_experiment)
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=args.batch_size, device=dev)
  config = ppo.PPOConfig(num_updates=args.num_updates,
                         rollout_length=args.rollout_length)
  train = ppo.make_train(env, config)
  suite = eval_lib.EVAL_SUITES[args.eval_suite]
  eval_env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config,
      batch_size=len(suite), device=dev)
  for seed in seeds:
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, metrics = train(seed)
    rate = metrics['terminal_rate'].cpu().numpy()
    seconds = time.perf_counter() - t0
    policy = ppo.as_policy(model, env, config)
    agg = eval_lib.aggregate_results(eval_lib.evaluate_batched(
        eval_env, eval_agent.mean_policy(policy), suite))
    yield (seed, seconds, rate, metrics['loss'].cpu().numpy(),
           agg.average_num_times_reached_goal, agg.average_num_actions_taken)


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--package', choices=('torch', 'jax'), required=True)
  parser.add_argument('--train_experiment', default='ppo_learned_2s')
  parser.add_argument('--batch_size', type=int, default=1024)
  parser.add_argument('--rollout_length', type=int, default=64)
  parser.add_argument('--num_updates', type=int, default=50)
  parser.add_argument('--seeds', default='0,1,2')
  parser.add_argument('--eval_suite', default='small_eval')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  sys.path.insert(0, ROOT)
  import numpy as np

  seeds = [int(s) for s in args.seeds.split(',')]
  runs = _jax_runs if args.package == 'jax' else _torch_runs
  late = slice(40, 50) if args.num_updates >= 50 else slice(-10, None)
  rows = []
  for seed, seconds, rate, loss, success, actions in runs(args, seeds):
    row = {'seed': seed, 'train_seconds': seconds,
           'terminal_rate_0_9': float(rate[:10].mean()),
           'terminal_rate_late': float(rate[late].mean()),
           'loss_finite': bool(np.isfinite(loss).all()),
           'success': float(success), 'actions': float(actions)}
    rows.append(row)
    print(json.dumps(row), flush=True)
  summary = {'package': args.package,
             'train_experiment': args.train_experiment,
             'batch_size': args.batch_size,
             'rollout_length': args.rollout_length,
             'num_updates': args.num_updates, 'late_window': str(late),
             'eval_suite': args.eval_suite}
  for key in ('terminal_rate_0_9', 'terminal_rate_late', 'success',
              'actions'):
    summary[key] = _mean_se([r[key] for r in rows])
  print(json.dumps(summary), flush=True)
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
      json.dump({**summary, 'seeds': rows}, f, indent=1)


if __name__ == '__main__':
  main()
