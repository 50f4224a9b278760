"""Evaluation CLI for the PyTorch port.

  python -m putting_dune_torch.eval --experiment_name=ppo_simple_images_tf \
      [--eval_suite=small_eval] [--device=cpu]

Experiments: relative_random_simple, greedy_simple_rates,
ppo_simple_images_tf, planner_simple_rates, vision_planner_simple_rates;
under instrument drift planner_simple_drift, ppo_simple_drift,
planner_simple_drift_variable_time, planner_simple_drift_frame_dwell,
vision_planner_drift and vision_planner_drift_corrected; the rate
stack's relative_random_prior_rates, planner_prior_rates{,_variable_time},
greedy_{,aligned_}prior_rates, planner_learned_rates,
planner_distilled_prior{,_variable_time} (the latter's checkpoint is not
shipped), vision_planner_{prior,learned}_rates and
eval_ppo_{learned_tf,v3}_{2,3,4}s (registry.eval_experiment_names()); and
the multi-dopant ones (registry.multi_dopant_experiment_names():
multi_dopant_{2,3,4}_planner, multi_dopant_{2,3,4}_random,
multi_dopant_{2,3}_{ppo,distilled,vision_planner},
multi_dopant_2_vision_planner_drift{,_corrected}).

Runs the suite as one batch of environments (CUDA by default; raises if
CUDA is absent unless --device=cpu) and prints the aggregate as JSON.
--no-batched (or --nobatched) runs the JAX package's host loop instead: one
episode per seed on the single-env wrapper, the registry's host agent
acting on each timestep (`eval_lib.evaluate`; the multi-dopant
experiments always run batched, as in the JAX package). --seed seeds the
host agent's numpy
generator and the wrapper; --output_json writes {experiment, suite,
aggregate, results} with NaN as null. --video_save_dir writes `{seed}.gif`
episode videos from either evaluator (the first 4 envs of a batch, every
seed of the host loop). --mesh=data or data:N evaluates data-parallel
over N ranks, one a device (parallel/mesh.py): from a plain `python -m`
the CLI launches the ranks itself, under torchrun it uses the world it
finds; each rank runs its contiguous block of the suite and rank 0 prints
the report over every seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
from typing import Optional


@dataclasses.dataclass
class Args:
  experiment_name: str
  eval_suite: str = 'tiny_eval'
  batched: bool = True
  video_save_dir: Optional[str] = None
  output_json: Optional[str] = None
  step_limit: int = 600
  seed: int = 0
  mesh: str = ''
  image_size: Optional[int] = None
  device: Optional[str] = None


def policy_for_agent(agent):
  """The batched policy of what an experiment's `get_policy` returned (the
  JAX package's `_policy_for_agent`): a registry agent (the planner,
  vision-planner and drift-corrected agents) exposes `policy()`, a
  callable or an `eval_lib.StatefulPolicy` that the loop carries; anything
  else already is a `(gen, observation) -> action` callable."""
  return agent.policy() if hasattr(agent, 'policy') else agent


def _multi_dopant_env_and_policy(args: Args, batch_size: int, device):
  """The env and batched policy of a D-dopant experiment; uniform random
  over the action spec where the experiment names no agent."""
  from putting_dune_torch import registry
  from putting_dune_torch.agents import agent_lib

  experiment = registry.create_multi_dopant_experiment(args.experiment_name)
  kwargs = {} if args.image_size is None else {'image_size': args.image_size}
  env = experiment.make_env(
      batch_size, step_limit=args.step_limit, device=device, **kwargs)
  if experiment.get_agent is not None:
    return env, policy_for_agent(experiment.get_agent(device))
  spec = env.action_spec()
  return env, functools.partial(
      agent_lib.uniform_random_policy, low=spec.minimum, high=spec.maximum,
      action_dim=spec.shape[0])


def main(args: Args) -> Optional[dict]:
  """Runs one eval; returns {'aggregate', 'results', 'env_steps', ...}
  (None in the process that launched the ranks of a --mesh=data:N run,
  which run `args` as their command line, `rank_argv(args)`)."""
  from putting_dune_torch.parallel import mesh as mesh_lib

  if args.mesh and not args.batched:
    raise ValueError('--mesh requires batched evaluation (drop --no-batched).')
  return mesh_lib.run_cli(args.mesh, args.device,
                          lambda mesh: _main(args, mesh),
                          'putting_dune_torch.eval', rank_argv(args))


def rank_argv(args: Args) -> list:
  """The command line that parses back to `args`: a flag a field."""
  argv = []
  for field in dataclasses.fields(Args):
    value = getattr(args, field.name)
    if field.name == 'batched':
      argv.append('--batched' if value else '--no-batched')
    elif value is not None:
      argv.append(f'--{field.name}={value}')
  return argv


def _main(args: Args, mesh) -> dict:
  from putting_dune_torch import device as device_lib
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  device = (device_lib.resolve_device(args.device) if mesh is None
            else mesh.device)
  seeds = eval_lib.EVAL_SUITES[args.eval_suite]
  batch = len(seeds) // (1 if mesh is None else mesh.shape['data'])
  if args.experiment_name in registry.multi_dopant_experiment_names():
    env, policy = _multi_dopant_env_and_policy(args, batch, device)
  elif not args.batched:
    return _report(args, device, *_evaluate_host(args, seeds, device))
  else:
    experiment = registry.create_eval_experiment(args.experiment_name)
    adapters_and_goal = experiment.get_adapters_and_goal()
    policy = policy_for_agent(
        experiment.get_policy(adapters_and_goal, device))
    env = run_helpers.create_batched_env(
        experiment.get_adapters_and_goal, experiment.get_simulator_config,
        batch_size=batch, step_limit=args.step_limit,
        image_size=args.image_size, device=device,
    )
  t0 = time.perf_counter()
  results = eval_lib.evaluate_batched(env, policy, seeds,
                                      video_save_dir=args.video_save_dir,
                                      mesh=mesh)
  _synchronize(device)
  seconds = time.perf_counter() - t0
  env_steps = len(seeds) * max(r.num_actions_taken for r in results)
  return _report(args, device, results, env_steps, seconds)


def _synchronize(device) -> None:
  if device.type == 'cuda':
    import torch

    torch.cuda.synchronize(device)


def _evaluate_host(args: Args, seeds, device):
  """The host loop: (results, env steps, wall seconds)."""
  import numpy as np

  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  experiment = registry.create_eval_experiment(args.experiment_name)
  rng = np.random.default_rng(args.seed)
  agent = registry.host_agent(
      experiment, rng, experiment.get_adapters_and_goal(), device)
  env = run_helpers.create_putting_dune_env(
      args.seed, experiment.get_adapters_and_goal,
      experiment.get_simulator_config, simulator_step_limit=args.step_limit,
      image_size=args.image_size, device=device)
  t0 = time.perf_counter()
  results = eval_lib.evaluate(agent, env, seeds,
                              video_save_dir=args.video_save_dir)
  _synchronize(device)
  seconds = time.perf_counter() - t0
  return results, sum(r.num_actions_taken for r in results), seconds


def _report(args: Args, device, results, env_steps, seconds) -> dict:
  """The report, and the JSON payload of --output_json (the JAX package's
  keys, NaN as null)."""
  from putting_dune_torch import eval_lib

  from putting_dune_torch.parallel import mesh as mesh_lib

  aggregate = dataclasses.asdict(eval_lib.aggregate_results(results))
  if args.output_json and mesh_lib.world()[0] == 0:
    payload = _json_safe({
        'experiment': args.experiment_name,
        'suite': args.eval_suite,
        'aggregate': aggregate,
        'results': [dataclasses.asdict(r) for r in results],
    })
    os.makedirs(os.path.dirname(args.output_json) or '.', exist_ok=True)
    with open(args.output_json, 'w') as f:
      json.dump(payload, f, allow_nan=False)
  return {
      'experiment': args.experiment_name,
      'suite': args.eval_suite,
      'device': str(device),
      'aggregate': aggregate,
      'env_steps': env_steps,
      'wall_seconds': seconds,
      'results': results,
  }


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
                      help='Rendered frame size (default: 512, or the '
                      "multi-dopant experiment's own).")
  parser.add_argument('--device', default=None,
                      help="'cuda' (default) or 'cpu'.")
  parser.add_argument('--batched', action=argparse.BooleanOptionalAction,
                      default=True,
                      help='One batch (default), or with --no-batched the '
                      'per-seed host loop.')
  parser.add_argument('--nobatched', dest='batched', action='store_false',
                      help='Same as --no-batched.')
  parser.add_argument('--video_save_dir', default=None,
                      help='Write {seed}.gif episode videos here.')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--output_json', default=None)
  parser.add_argument('--mesh', default='',
                      help="Data-parallel ranks: 'data' (every device) or "
                      "'data:N'; empty is the single-device program.")
  return Args(**vars(parser.parse_args(argv)))


def cli(argv=None) -> None:
  from putting_dune_torch.parallel import mesh as mesh_lib

  report = main(_parse_args(argv))
  if report is None or mesh_lib.world()[0] != 0:
    return
  report.pop('results')
  print(json.dumps(_json_safe(report)))


if __name__ == '__main__':
  cli()
