"""PPO training CLI (port of putting_dune_tpu/agents/train_ppo.py).

Trains a policy on a named train experiment (registry.py) with the port's
PPO trainer, saves the checkpoint under <workdir>/policy, the per-update
metrics as <workdir>/train_metrics.npz and, unless --eval_suite is empty,
the eval summary as <workdir>/eval.json:

  python -m putting_dune_torch.agents.train_ppo \\
      --train_experiment=relative_simple_rates --workdir=/tmp/ppo \\
      --num_updates=300 --batch_size=1024

Runs on CUDA unless --device=cpu. --mesh=data or data:N trains
data-parallel over N ranks, one a device (parallel/mesh.py): each rank
steps batch_size / N envs, the gradients are all-reduced, rank 0 writes
the files, and the eval after training runs over the same ranks. From a
plain `python -m` the CLI launches the ranks itself; under torchrun it
uses the world it finds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--train_experiment', default='relative_simple_rates')
  parser.add_argument('--workdir', required=True)
  parser.add_argument('--batch_size', type=int, default=1024)
  parser.add_argument('--num_updates', type=int, default=300)
  parser.add_argument('--rollout_length', type=int, default=64)
  parser.add_argument('--learning_rate', type=float, default=3e-4)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--eval_suite', default='small_eval')
  parser.add_argument(
      '--updates_per_chunk', type=int, default=None,
      help='Chunked training: save a rolling checkpoint every N updates.')
  parser.add_argument(
      '--max_wall_seconds', type=float, default=None,
      help='Stop after this much wall time (chunked mode only).')
  parser.add_argument(
      '--reward_shaping', type=float, default=0.0,
      help='Potential-based shaping coefficient (0 = off). Training only; '
      'the eval uses the true sparse reward.')
  parser.add_argument(
      '--render_size', type=int, default=None,
      help='Rendered STEM frame resolution for image envs (default 512; '
      'training pixel policies at 256 or 128 is much faster).')
  parser.add_argument(
      '--init_params_from', default=None,
      help='Warm-start from a saved actor_critic checkpoint directory.')
  parser.add_argument(
      '--mesh', default='',
      help="Data-parallel device mesh: 'data' (all devices) or 'data:N'. "
      'Shards the env batch (and eval seeds) over the ranks; params stay '
      'replicated. Empty = single-device program.')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'.")
  return parser


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
  """Trains and evaluates; returns {'metrics', 'eval'} (None in the process
  that launched the ranks of a --mesh=data:N run)."""
  from putting_dune_torch.parallel import mesh as mesh_lib

  argv = list(sys.argv[1:] if argv is None else argv)
  args = build_parser().parse_args(argv)
  return mesh_lib.run_cli(args.mesh, args.device,
                          lambda mesh: _main(args, mesh),
                          'putting_dune_torch.agents.train_ppo', argv)


def _main(args, mesh) -> dict:
  from putting_dune_torch import device as device_lib
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.agents import ppo

  device = (device_lib.resolve_device(args.device) if mesh is None
            else mesh.device)
  ranks = 1 if mesh is None else mesh.shape['data']
  writer = mesh is None or mesh.rank == 0
  if args.batch_size % ranks:
    raise ValueError(f'--batch_size={args.batch_size} does not split over '
                     f'{ranks} ranks')
  experiment = registry.create_train_experiment(args.train_experiment)
  env = run_helpers.create_batched_env(
      experiment.get_adapters_and_goal, experiment.get_simulator_config,
      batch_size=args.batch_size // ranks, image_size=args.render_size,
      device=device)
  config = ppo.PPOConfig(
      num_updates=args.num_updates,
      rollout_length=args.rollout_length,
      learning_rate=args.learning_rate,
      reward_shaping_coef=args.reward_shaping,
  )
  os.makedirs(args.workdir, exist_ok=True)
  policy, metrics = ppo.train_and_save(
      env, os.path.join(args.workdir, 'policy'), config=config,
      seed=args.seed,
      updates_per_chunk=args.updates_per_chunk,
      max_wall_seconds=args.max_wall_seconds,
      log_every_chunk=args.updates_per_chunk is not None,
      init_params_from=args.init_params_from,
      mesh=mesh,
  )
  if writer:
    np.savez_compressed(os.path.join(args.workdir, 'train_metrics.npz'),
                        **metrics)
    print('terminal rate first/last 10 updates:',
          float(metrics['terminal_rate'][:10].mean()),
          float(metrics['terminal_rate'][-10:].mean()), flush=True)

  summary = {}
  if args.eval_suite:
    seeds = eval_lib.EVAL_SUITES[args.eval_suite]
    eval_env = run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=len(seeds) // ranks, device=device)
    results = eval_lib.evaluate_batched(
        eval_env, eval_agent.mean_policy(policy), seeds, mesh=mesh)
    aggregate = eval_lib.aggregate_results(results)
    summary = {
        'success_rate': aggregate.average_num_times_reached_goal,
        'avg_actions': aggregate.average_num_actions_taken,
        'avg_total_reward': aggregate.average_total_reward,
    }
    if writer:
      print('eval:', json.dumps(summary), flush=True)
      with open(os.path.join(args.workdir, 'eval.json'), 'w') as f:
        json.dump(summary, f)
  return {'metrics': metrics, 'eval': summary}


if __name__ == '__main__':
  main()
