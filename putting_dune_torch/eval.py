"""Evaluation CLI for the PyTorch port.

  python -m putting_dune_torch.eval --experiment_name=ppo_simple_images_tf \
      [--eval_suite=small_eval] [--device=cpu]

Experiments: relative_random_simple, greedy_simple_rates,
ppo_simple_images_tf, planner_simple_rates, vision_planner_simple_rates.

Runs the suite as one batch of environments (CUDA by default; raises if
CUDA is absent unless --device=cpu) and prints the aggregate as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Optional


@dataclasses.dataclass
class Args:
  experiment_name: str
  eval_suite: str = 'tiny_eval'
  step_limit: int = 600
  image_size: Optional[int] = None
  device: Optional[str] = None


def policy_for_agent(agent):
  """The batched policy of what an experiment's `get_policy` returned (the
  JAX package's `_policy_for_agent`): a registry agent (PlannerAgent,
  VisionPlannerAgent) exposes `policy()`; anything else already is a
  `(gen, observation) -> action` callable."""
  from putting_dune_torch.agents import planner as planner_lib
  from putting_dune_torch.agents import vision_planner as vision_planner_lib

  if isinstance(agent, (planner_lib.PlannerAgent,
                        vision_planner_lib.VisionPlannerAgent)):
    return agent.policy()
  return agent


def main(args: Args) -> dict:
  """Runs one eval; returns {'aggregate', 'results', 'env_steps', ...}."""
  from putting_dune_torch import device as device_lib
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  device = device_lib.resolve_device(args.device)
  seeds = eval_lib.EVAL_SUITES[args.eval_suite]
  experiment = registry.create_eval_experiment(args.experiment_name)
  adapters_and_goal = experiment.get_adapters_and_goal()
  policy = policy_for_agent(
      experiment.get_policy(adapters_and_goal, device))
  env = run_helpers.create_batched_env(
      experiment.get_adapters_and_goal, experiment.get_simulator_config,
      batch_size=len(seeds), step_limit=args.step_limit,
      image_size=args.image_size, device=device,
  )
  t0 = time.perf_counter()
  results = eval_lib.evaluate_batched(env, policy, seeds)
  if device.type == 'cuda':
    import torch

    torch.cuda.synchronize(device)
  seconds = time.perf_counter() - t0
  aggregate = eval_lib.aggregate_results(results)
  env_steps = len(seeds) * max(r.num_actions_taken for r in results)
  report = {
      'experiment': args.experiment_name,
      'suite': args.eval_suite,
      'device': str(device),
      'aggregate': dataclasses.asdict(aggregate),
      'env_steps': env_steps,
      'wall_seconds': seconds,
  }
  report['results'] = results
  return report


def _json_safe(obj):
  if isinstance(obj, dict):
    return {k: _json_safe(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_json_safe(v) for v in obj]
  if isinstance(obj, float) and math.isnan(obj):
    return None
  return obj


def _parse_args(argv=None) -> Args:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--experiment_name', required=True)
  parser.add_argument('--eval_suite', default='tiny_eval')
  parser.add_argument('--step_limit', type=int, default=600)
  parser.add_argument('--image_size', type=int, default=None,
                      help='Rendered frame size (default 512).')
  parser.add_argument('--device', default=None,
                      help="'cuda' (default) or 'cpu'.")
  return Args(**vars(parser.parse_args(argv)))


def cli(argv=None) -> None:
  report = main(_parse_args(argv))
  report.pop('results')
  print(json.dumps(_json_safe(report)))


if __name__ == '__main__':
  cli()
