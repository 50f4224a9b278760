"""Named eval experiments (port of part of
putting_dune_tpu/experiments/registry.py).

Same names and compositions as the JAX package for the three experiments
ported so far. An experiment's `get_policy(adapters_and_goal, device)`
returns a batched policy `(gen, observation) -> action`.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable

from putting_dune_torch import constants
from putting_dune_torch import rates as rates_lib
from putting_dune_torch.agents import agent_lib
from putting_dune_torch.agents import eval_agent
from putting_dune_torch.env import action_adapters
from putting_dune_torch.env import features as features_lib

BOND = constants.CARBON_BOND_DISTANCE_ANGSTROMS


@dataclasses.dataclass(frozen=True)
class AdaptersAndGoal:
  action_adapter: Any
  feature_constructor: Any


@dataclasses.dataclass(frozen=True)
class SimulatorSpec:
  rate_fn: rates_lib.RateFunction
  image_duration_seconds: float = 2.0
  drift_per_frame_angstroms: float = 0.0


@dataclasses.dataclass(frozen=True)
class EvalExperiment:
  get_policy: Callable[[AdaptersAndGoal, Any], Callable]
  get_adapters_and_goal: Callable[[], AdaptersAndGoal]
  get_simulator_config: Callable[[], SimulatorSpec]


def _random_policy(adapters_and_goal, device):
  del device
  spec = adapters_and_goal.action_adapter.spec()
  return functools.partial(
      agent_lib.uniform_random_policy, low=spec.minimum, high=spec.maximum,
      action_dim=spec.shape[0],
  )


def _greedy_policy(adapters_and_goal, device, argmax=(1.42, 0.0)):
  del adapters_and_goal, device
  return functools.partial(agent_lib.greedy_policy, argmax=argmax)


def _checkpoint_policy(model_name: str):
  def get_policy(adapters_and_goal, device):
    del adapters_and_goal
    path = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, model_name)
    if not os.path.isdir(path):
      raise FileNotFoundError(f'No policy checkpoint at {path}.')
    return eval_agent.mean_policy(eval_agent.load_policy(path, device))
  return get_policy


def _single_silicon_goal_reaching():
  return AdaptersAndGoal(
      action_adapter=action_adapters.RelativeToSiliconActionAdapter(),
      feature_constructor=features_lib.SingleSiliconPristineGrapheneFeatures(),
  )


def _single_silicon_from_pixels():
  return AdaptersAndGoal(
      action_adapter=action_adapters.RelativeToSiliconActionAdapter(),
      feature_constructor=features_lib.ImageFeatures(image_size=128),
  )


def _greedy_material_frame_5s():
  return AdaptersAndGoal(
      action_adapter=(
          action_adapters.RelativeToSiliconMaterialFrameActionAdapter(
              min_dwell_seconds=5.0, max_dwell_seconds=5.0,
              max_distance_angstroms=2 * BOND)),
      feature_constructor=features_lib.SingleSiliconMaterialFrameFeatures(),
  )


def _simple_rates_config():
  return SimulatorSpec(rate_fn=rates_lib.simple_canonical_rates,
                       image_duration_seconds=2.0)


_EVAL_EXPERIMENTS = {
    'relative_random_simple': EvalExperiment(
        get_policy=_random_policy,
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_simple_rates_config,
    ),
    'ppo_simple_images_tf': EvalExperiment(
        get_policy=_checkpoint_policy('ppo_simple_images_tf'),
        get_adapters_and_goal=_single_silicon_from_pixels,
        get_simulator_config=_simple_rates_config,
    ),
    'greedy_simple_rates': EvalExperiment(
        get_policy=_greedy_policy,
        get_adapters_and_goal=_greedy_material_frame_5s,
        get_simulator_config=_simple_rates_config,
    ),
}


def create_eval_experiment(name: str) -> EvalExperiment:
  if name not in _EVAL_EXPERIMENTS:
    raise ValueError(f'Unknown eval experiment {name}.')
  return _EVAL_EXPERIMENTS[name]


def eval_experiment_names():
  return tuple(_EVAL_EXPERIMENTS)
