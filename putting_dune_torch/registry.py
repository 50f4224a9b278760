"""Named experiments (port of putting_dune_tpu/experiments/registry.py).

The same names and compositions as the JAX package: all of its
single-dopant eval experiments, all of its multi-dopant ones, its train
experiments (the env a trainer builds: adapters, features and simulator)
and its microscope experiments (an agent and the adapters for the
real-microscope loop, microscope_agent.py). An eval experiment's
`get_policy(adapters_and_goal, device)` returns a batched policy
`(gen, observation) -> action`, or an agent whose `policy()` gives one
(eval.py `policy_for_agent`); `host_agent` gives the host agent (dm_env
`step`) the host evaluator drives. The multi-dopant experiments carry an
env factory and, unless the policy is uniform random, a
`get_agent(device)` with the same kind of result.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Optional

import numpy as np

from putting_dune_torch import constants
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch.agents import agent_lib
from putting_dune_torch.agents import drift_correction
from putting_dune_torch.agents import eval_agent
from putting_dune_torch.agents import planner as planner_lib
from putting_dune_torch.agents import vision_planner as vision_planner_lib
from putting_dune_torch.env import action_adapters
from putting_dune_torch.env import features as features_lib
from putting_dune_torch.env import multi_dopant

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


AgentConstructor = Callable[[np.random.Generator, AdaptersAndGoal], Any]
AdaptersAndGoalConstructor = Callable[[], AdaptersAndGoal]
SimulatorSpecConstructor = Callable[[], SimulatorSpec]


@dataclasses.dataclass(frozen=True)
class TrainExperiment:
  get_adapters_and_goal: AdaptersAndGoalConstructor
  get_simulator_config: SimulatorSpecConstructor


@dataclasses.dataclass(frozen=True)
class EvalExperiment:
  """get_agent(rng, adapters_and_goal, device), where set, builds the host
  agent; otherwise `get_policy`'s agent is also the host agent."""

  get_policy: Callable[[AdaptersAndGoal, Any], Callable]
  get_adapters_and_goal: AdaptersAndGoalConstructor
  get_simulator_config: SimulatorSpecConstructor
  get_agent: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class MicroscopeExperiment:
  """An agent for the real-microscope loop: get_agent(rng,
  adapters_and_goal, device=None) -> host agent."""

  get_agent: Callable
  get_adapters_and_goal: AdaptersAndGoalConstructor


def host_agent(experiment: EvalExperiment, rng: np.random.Generator,
               adapters_and_goal: AdaptersAndGoal, device=None
               ) -> agent_lib.Agent:
  """The host agent (dm_env `step`) of an eval experiment; raises
  NotImplementedError where its agent has no host step (the vision
  planners, as in the JAX package)."""
  if experiment.get_agent is not None:
    return experiment.get_agent(rng, adapters_and_goal, device)
  agent = experiment.get_policy(adapters_and_goal, device)
  if not isinstance(agent, agent_lib.Agent):
    raise NotImplementedError(
        f'{type(agent).__name__} has no host step; evaluate it batched.')
  return agent


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


def _relative_random_agent(rng, adapters_and_goal, device=None):
  del device
  spec = adapters_and_goal.action_adapter.spec()
  return agent_lib.UniformRandomAgent(rng, spec.minimum, spec.maximum,
                                      spec.shape)


def _greedy_agent(rng, adapters_and_goal, device=None, argmax=(1.42, 0.0)):
  del adapters_and_goal
  return agent_lib.GreedyAgent(rng=rng, argmax=np.asarray(argmax),
                               device=device)


def _checkpoint_path(model_name: str, weights_dir: Optional[str] = None
                     ) -> str:
  path = os.path.join(weights_dir or eval_agent.MODEL_WEIGHTS_DIR,
                      model_name)
  if not os.path.isdir(path):
    raise FileNotFoundError(f'No policy checkpoint at {path}.')
  return path


def _checkpoint_policy(model_name: str):
  def get_policy(adapters_and_goal, device):
    del adapters_and_goal
    return eval_agent.mean_policy(
        eval_agent.load_policy(_checkpoint_path(model_name), device))
  return get_policy


@dataclasses.dataclass(frozen=True)
class PolicyCheckpointAgent:
  """get_agent of a policy checkpoint: an `EvalAgent` over
  `<weights_dir>/<model_name>` (the shipped `model_weights/` unless
  weights_dir is given); raises FileNotFoundError where the directory is
  absent."""

  model_name: str
  weights_dir: Optional[str] = None

  def __call__(self, rng, adapters_and_goal, device=None):
    del rng, adapters_and_goal
    return eval_agent.EvalAgent.load(
        _checkpoint_path(self.model_name, self.weights_dir), device)


def _checkpoint_entry(model_name: str) -> dict:
  """get_policy and get_agent of an eval entry over a checkpoint."""
  return dict(get_policy=_checkpoint_policy(model_name),
              get_agent=PolicyCheckpointAgent(model_name))


def _load_shipped_rate_fn(device):
  """The shipped distilled neural rate model as a RateFunction on
  `device`; raises FileNotFoundError when the artifact is absent."""
  from putting_dune_torch.rate_learning import config as rl_config
  from putting_dune_torch.rate_learning import predictor as predictor_lib

  workdir = os.path.join(eval_agent.MODEL_WEIGHTS_DIR, 'rate_predictor')
  if not os.path.isdir(workdir):
    raise FileNotFoundError(f'No shipped rate predictor at {workdir}.')
  predictor = predictor_lib.LearnedRatePredictor(
      config=rl_config.RateLearningConfig(beam_units='angstroms'),
      device=device)
  predictor.load(workdir)
  return predictor.as_rate_function()


def _planner_agent(adapters_and_goal, device, rate_fn=None,
                    lookahead_discount=0.0, dwell_objective='per_second'):
  """Rate-aware planner; its dwell (or dwell range) is the adapter's, so
  the probabilities it optimizes are the ones the simulator realizes."""
  adapter = adapters_and_goal.action_adapter
  dwell_range = None
  if adapter.max_dwell_seconds > adapter.min_dwell_seconds:
    dwell_range = (float(adapter.min_dwell_seconds),
                   float(adapter.max_dwell_seconds))
  return planner_lib.PlannerAgent(
      rate_fn=rate_fn if rate_fn is not None else rates_lib.prior_rates,
      dwell_seconds=float(adapter.min_dwell_seconds),
      lookahead_discount=lookahead_discount,
      dwell_range_seconds=dwell_range,
      dwell_objective=dwell_objective,
      device=device,
  )


def _learned_planner_agent(adapters_and_goal, device):
  """The planner over the shipped distilled neural rate model: simulate ->
  learn rates -> plan with the learned model."""
  adapter = adapters_and_goal.action_adapter
  return planner_lib.PlannerAgent(
      rate_fn=_load_shipped_rate_fn(device),
      dwell_seconds=float(adapter.min_dwell_seconds),
      device=device,
  )


def _vision_planner_agent(adapters_and_goal, device, rate_fn=None):
  """Shipped detector -> lattice geometry -> planner; rate_fn='learned'
  plans with the shipped distilled neural rate model."""
  if rate_fn == 'learned':
    rate_fn = _load_shipped_rate_fn(device)
  adapter = adapters_and_goal.action_adapter
  return vision_planner_lib.VisionPlannerAgent(
      rate_fn=(rate_fn if rate_fn is not None
               else rates_lib.simple_canonical_rates),
      dwell_seconds=float(adapter.min_dwell_seconds),
      max_distance_angstroms=float(adapter.max_distance_angstroms),
      device=device,
  )


def _drift_corrected_vision_planner_agent(adapters_and_goal, device):
  """Vision planner with in-loop phase-correlation drift correction:
  drifting microscope -> pixels -> shipped UNet -> geometry and drift
  estimate -> rate-aware planner."""
  adapter = adapters_and_goal.action_adapter
  return drift_correction.DriftCorrectedVisionPlannerAgent(
      rate_fn=rates_lib.simple_canonical_rates,
      dwell_seconds=float(adapter.min_dwell_seconds),
      max_distance_angstroms=float(adapter.max_distance_angstroms),
      device=device,
  )


def _single_silicon_goal_reaching(min_dwell_seconds=1.5, max_dwell_seconds=1.5,
                                  max_distance_angstroms=BOND):
  """Microscope-frame relative adapter + the 10-dim vector features."""
  return AdaptersAndGoal(
      action_adapter=action_adapters.RelativeToSiliconActionAdapter(
          min_dwell_seconds=min_dwell_seconds,
          max_dwell_seconds=max_dwell_seconds,
          max_distance_angstroms=max_distance_angstroms),
      feature_constructor=features_lib.SingleSiliconPristineGrapheneFeatures(),
  )


def _single_silicon_from_pixels(
    min_dwell_seconds=1.5, max_dwell_seconds=1.5, max_distance_angstroms=BOND,
    image_size=128, include_fov=False,
):
  return AdaptersAndGoal(
      action_adapter=action_adapters.RelativeToSiliconActionAdapter(
          min_dwell_seconds=min_dwell_seconds,
          max_dwell_seconds=max_dwell_seconds,
          max_distance_angstroms=max_distance_angstroms),
      feature_constructor=features_lib.ImageFeatures(
          image_size=image_size, include_fov=include_fov),
  )


def _direct_from_pixels():
  """Absolute [0, 1]^2 beam placement + image features."""
  return AdaptersAndGoal(
      action_adapter=action_adapters.DirectActionAdapter(),
      feature_constructor=features_lib.ImageFeatures(),
  )


def _material_frame(min_dwell_seconds=5.0, max_dwell_seconds=5.0):
  """Material-frame features and actions, 2 bonds; a fixed 5 s dwell by
  default."""
  return AdaptersAndGoal(
      action_adapter=(
          action_adapters.RelativeToSiliconMaterialFrameActionAdapter(
              min_dwell_seconds=min_dwell_seconds,
              max_dwell_seconds=max_dwell_seconds,
              max_distance_angstroms=2 * BOND)),
      feature_constructor=features_lib.SingleSiliconMaterialFrameFeatures(),
  )


# The planner picks the dwell too, from 1.5 to 20 s (a third action dim).
_material_frame_variable_dwell = functools.partial(
    _material_frame, min_dwell_seconds=1.5, max_dwell_seconds=20.0)


def _simple_rates_config():
  return SimulatorSpec(rate_fn=rates_lib.simple_canonical_rates,
                       image_duration_seconds=2.0)


def _human_prior_rates_config():
  return SimulatorSpec(rate_fn=rates_lib.prior_rates,
                       image_duration_seconds=2.0)


def _aligned_prior_rates_config():
  return SimulatorSpec(rate_fn=rates_lib.prior_rates_aligned,
                       image_duration_seconds=2.0)


def _prior_rates_config_with_duration(image_duration_seconds: float):
  return SimulatorSpec(rate_fn=rates_lib.prior_rates,
                       image_duration_seconds=image_duration_seconds)


def _simple_rates_drift_config():
  """Simple rates + cumulative instrument drift. 0.5 A per frame per axis
  keeps the worst per-step increment (0.71 A diagonal) below half the
  graphene Bravais constant, so the corrector's search window can keep out
  the lattice's alias peaks (agents/drift_correction.py)."""
  return SimulatorSpec(rate_fn=rates_lib.simple_canonical_rates,
                       image_duration_seconds=2.0,
                       drift_per_frame_angstroms=0.5)


# The pixel loops under drift: the drift-free vision planner's adapters,
# with the believed FOV in the features for the corrector.
_drift_from_pixels = functools.partial(
    _single_silicon_from_pixels, min_dwell_seconds=5.0,
    max_dwell_seconds=5.0, max_distance_angstroms=2 * BOND, image_size=256,
    include_fov=True)


# The vision planners' adapters: image features at 256^2, the detector's
# training size; 5 s dwell like the other planners.
_vision_from_pixels = functools.partial(
    _single_silicon_from_pixels, min_dwell_seconds=5.0,
    max_dwell_seconds=5.0, max_distance_angstroms=2 * BOND, image_size=256)

_EVAL_EXPERIMENTS = {
    'relative_random_simple': EvalExperiment(
        get_policy=_random_policy,
        get_agent=_relative_random_agent,
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_simple_rates_config,
    ),
    'relative_random_prior_rates': EvalExperiment(
        get_policy=_random_policy,
        get_agent=_relative_random_agent,
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_human_prior_rates_config,
    ),
    'ppo_simple_images_tf': EvalExperiment(
        **_checkpoint_entry('ppo_simple_images_tf'),
        get_adapters_and_goal=_single_silicon_from_pixels,
        get_simulator_config=_simple_rates_config,
    ),
    'greedy_simple_rates': EvalExperiment(
        get_policy=_greedy_policy,
        get_agent=_greedy_agent,
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_simple_rates_config,
    ),
    'planner_simple_rates': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.simple_canonical_rates),
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_simple_rates_config,
    ),
    'planner_prior_rates': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.prior_rates),
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_human_prior_rates_config,
    ),
    'greedy_prior_rates': EvalExperiment(
        get_policy=_greedy_policy,
        get_agent=_greedy_agent,
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_human_prior_rates_config,
    ),
    # Model-based control with the learned dynamics model: the simulator
    # runs the aligned prior, the planner plans with the shipped distilled
    # neural predictor trained on data simulated from that law.
    'planner_learned_rates': EvalExperiment(
        get_policy=_learned_planner_agent,
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_aligned_prior_rates_config,
    ),
    # The planner also picks the dwell each step, maximizing expected
    # progress per simulated second (a third action dim).
    'planner_prior_rates_variable_time': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.prior_rates),
        get_adapters_and_goal=_material_frame_variable_dwell,
        get_simulator_config=_human_prior_rates_config,
    ),
    # The planner distilled into a feed-forward MLP (shipped), and its
    # variable-dwell twin, whose checkpoint is not shipped.
    'planner_distilled_prior': EvalExperiment(
        **_checkpoint_entry('planner_distilled_prior'),
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_human_prior_rates_config,
    ),
    'planner_distilled_prior_variable_time': EvalExperiment(
        **_checkpoint_entry('planner_distilled_prior_variable_time'),
        get_adapters_and_goal=_material_frame_variable_dwell,
        get_simulator_config=_human_prior_rates_config,
    ),
    'greedy_aligned_prior_rates': EvalExperiment(
        get_policy=_greedy_policy,
        get_agent=_greedy_agent,
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_aligned_prior_rates_config,
    ),
    # Pixels to control with no policy learning.
    'vision_planner_simple_rates': EvalExperiment(
        get_policy=_vision_planner_agent,
        get_adapters_and_goal=_vision_from_pixels,
        get_simulator_config=_simple_rates_config,
    ),
    # The vision planner under the aligned prior with the analytic model,
    # which isolates perception error from learned-model error in the
    # composition below.
    'vision_planner_prior_rates': EvalExperiment(
        get_policy=functools.partial(
            _vision_planner_agent, rate_fn=rates_lib.prior_rates_aligned),
        get_adapters_and_goal=_vision_from_pixels,
        get_simulator_config=_aligned_prior_rates_config,
    ),
    # Both shipped learned artifacts in one controller: UNet perception and
    # the distilled neural rate model as the planning model, against the
    # aligned-prior simulator the rate model was trained on.
    'vision_planner_learned_rates': EvalExperiment(
        get_policy=functools.partial(_vision_planner_agent, rate_fn='learned'),
        get_adapters_and_goal=_vision_from_pixels,
        get_simulator_config=_aligned_prior_rates_config,
    ),
    # Under instrument drift. Vector features: the neighbor deltas are
    # translation invariant, so only the recorded goal vector goes stale.
    'planner_simple_drift': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.simple_canonical_rates),
        get_adapters_and_goal=_material_frame,
        get_simulator_config=_simple_rates_drift_config,
    ),
    # The shipped policy trained under drift, on its training adapters.
    'ppo_simple_drift': EvalExperiment(
        **_checkpoint_entry('ppo_simple_drift'),
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_simple_rates_drift_config,
    ),
    # Variable dwell under drift: drift accumulates per frame, so longer
    # dwells buy more KMC progress per unit of drift.
    'planner_simple_drift_variable_time': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.simple_canonical_rates),
        get_adapters_and_goal=_material_frame_variable_dwell,
        get_simulator_config=_simple_rates_drift_config,
    ),
    # The drift-aware dwell objective: progress per frame, with a Poisson
    # overshoot penalty for transitions after the first.
    'planner_simple_drift_frame_dwell': EvalExperiment(
        get_policy=functools.partial(
            _planner_agent, rate_fn=rates_lib.simple_canonical_rates,
            dwell_objective='per_frame'),
        get_adapters_and_goal=_material_frame_variable_dwell,
        get_simulator_config=_simple_rates_drift_config,
    ),
    # The vision planner on a drifting microscope, uncorrected (the goal
    # vector goes stale by the cumulative drift) and with the in-loop
    # phase-correlation corrector.
    'vision_planner_drift': EvalExperiment(
        get_policy=_vision_planner_agent,
        get_adapters_and_goal=_drift_from_pixels,
        get_simulator_config=_simple_rates_drift_config,
    ),
    'vision_planner_drift_corrected': EvalExperiment(
        get_policy=_drift_corrected_vision_planner_agent,
        get_adapters_and_goal=_drift_from_pixels,
        get_simulator_config=_simple_rates_drift_config,
    ),
}


# The shipped vector-policy checkpoints, each on the adapters of its
# microscope experiment in the JAX registry (1.0-10.0 s dwell, or 1.5-20 s
# at 3 bonds), under the human prior.
_ZOO = {
    'ppo_learned_tf_2s': ('230127_from_state_2s', (1.0, 10.0, BOND)),
    'ppo_learned_tf_3s': ('230127_from_state_3s', (1.0, 10.0, BOND)),
    'ppo_learned_tf_4s': ('230127_from_state_4s', (1.0, 10.0, BOND)),
    'ppo_v3_2s': ('230422_ppo_v3_2s', (1.5, 20.0, 3 * BOND)),
    'ppo_v3_3s': ('230422_ppo_v3_3s', (1.5, 20.0, 3 * BOND)),
    'ppo_v3_4s': ('230422_ppo_v3_4s', (1.5, 20.0, 3 * BOND)),
}
_EVAL_EXPERIMENTS.update({
    f'eval_{name}': EvalExperiment(
        **_checkpoint_entry(checkpoint),
        get_adapters_and_goal=functools.partial(
            _single_silicon_goal_reaching, *adapter),
        get_simulator_config=_human_prior_rates_config,
    )
    for name, (checkpoint, adapter) in _ZOO.items()
})


def register_eval_experiment(name: str, eval_experiment: EvalExperiment
                             ) -> None:
  """Adds an eval experiment if the name is not taken yet."""
  if name not in _EVAL_EXPERIMENTS:
    _EVAL_EXPERIMENTS[name] = eval_experiment


def create_eval_experiment(name: str) -> EvalExperiment:
  if name not in _EVAL_EXPERIMENTS:
    raise ValueError(f'Unknown eval experiment {name}.')
  return _EVAL_EXPERIMENTS[name]


def eval_experiment_names():
  return tuple(_EVAL_EXPERIMENTS)


# -------------------- train experiments ---------------------------------------

_TRAIN_EXPERIMENTS = {
    'relative_simple_rates': TrainExperiment(
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_simple_rates_config,
    ),
    'relative_prior_rates': TrainExperiment(
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_human_prior_rates_config,
    ),
    # The vector task on a drifting microscope: the goal vector goes stale
    # over the episode, and the policy never observes the drift.
    'relative_simple_rates_drift': TrainExperiment(
        get_adapters_and_goal=_single_silicon_goal_reaching,
        get_simulator_config=_simple_rates_drift_config,
    ),
    'relative_simple_rates_from_images': TrainExperiment(
        get_adapters_and_goal=_single_silicon_from_pixels,
        get_simulator_config=_simple_rates_config,
    ),
    'relative_simple_rates_from_images_variable_time': TrainExperiment(
        get_adapters_and_goal=functools.partial(
            _single_silicon_from_pixels, min_dwell_seconds=1.0,
            max_dwell_seconds=10.0),
        get_simulator_config=_simple_rates_config,
    ),
    'direct_simple_rates_from_images': TrainExperiment(
        get_adapters_and_goal=_direct_from_pixels,
        get_simulator_config=_simple_rates_config,
    ),
}

# The training configurations of the shipped zoo checkpoints: each on the
# adapters of its eval entry (_ZOO), under the human prior, with the image
# duration of its name.
_TRAIN_EXPERIMENTS.update({
    f'ppo_{family}_{n}s': TrainExperiment(
        get_adapters_and_goal=functools.partial(
            _single_silicon_goal_reaching, *adapter),
        get_simulator_config=functools.partial(
            _prior_rates_config_with_duration, float(n)),
    )
    for family, adapter in (('learned', (1.0, 10.0, BOND)),
                            ('v3', (1.5, 20.0, 3 * BOND)))
    for n in (2, 3, 4)
})


def create_train_experiment(name: str) -> TrainExperiment:
  if name not in _TRAIN_EXPERIMENTS:
    raise ValueError(f'Unknown train experiment {name}.')
  return _TRAIN_EXPERIMENTS[name]


def train_experiment_names():
  return tuple(_TRAIN_EXPERIMENTS)


# -------------------- multi-dopant experiments -------------------------------


@dataclasses.dataclass(frozen=True)
class MultiDopantExperiment:
  """Eval experiment over the D-dopant env.

  make_env(batch_size, step_limit=..., device=...) builds the environment
  (settings must match what the checkpoint, if any, was trained on);
  get_agent(device) returns a batched policy or an agent with `policy()`
  (eval.py `policy_for_agent`), and is None for a uniform-random policy.
  """

  make_env: Callable
  get_agent: Optional[Callable] = None
  num_dopants: int = 2


def _make_multi_dopant_env(
    batch_size: int,
    *,
    num_dopants: int,
    dwell_seconds: float = 5.0,
    grid_columns: int = 50,
    step_limit: int = 600,
    observation_mode: str = 'vector',
    anchor_order: str = 'index',
    image_size: int = 128,
    drift_per_frame_angstroms: float = 0.0,
    include_fov: bool = False,
    device=None,
):
  """Env factory matching the shipped multi_dopant_2 training settings:
  lattice 50, simple rates, 5 s dwell, relative action mode, sticky
  goals."""
  from putting_dune_torch import device as device_lib

  device = device_lib.resolve_device(device)
  return multi_dopant.MultiDopantEnv(
      lattice=lattice_lib.make_lattice(grid_columns, device),
      rate_fn=rates_lib.simple_canonical_rates,
      batch_size=batch_size,
      num_dopants=num_dopants,
      dwell_seconds=dwell_seconds,
      step_limit=step_limit,
      observation_mode=observation_mode,
      anchor_order=anchor_order,
      image_size=image_size,
      drift_per_frame_angstroms=drift_per_frame_angstroms,
      include_fov=include_fov,
      device=device,
  )


def _checkpoint_agent(model_name: str):
  """get_agent for a shipped policy checkpoint."""
  return functools.partial(_checkpoint_policy(model_name), None)


@dataclasses.dataclass(frozen=True)
class _MultiDopantPlannerFactory:
  """get_agent for planner-driven multi-dopant experiments (needs the
  'vector_neighbors' observation mode so the anchor geometry is visible)."""

  num_dopants: int
  dwell_seconds: float = 5.0

  def __call__(self, device):
    del device
    return planner_lib.MultiDopantPlannerAgent(
        rate_fn=rates_lib.simple_canonical_rates,
        num_dopants=self.num_dopants,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=2.0 * BOND,
    )


@dataclasses.dataclass(frozen=True)
class _MultiDopantVisionPlannerFactory:
  """get_agent for the D-dopant vision planner ('image' observations +
  anchor_order='position')."""

  num_dopants: int
  dwell_seconds: float = 5.0

  def __call__(self, device):
    return vision_planner_lib.MultiDopantVisionPlannerAgent(
        rate_fn=rates_lib.simple_canonical_rates,
        num_dopants=self.num_dopants,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=2.0 * BOND,
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class _MultiDopantDriftCorrectedVisionPlannerFactory:
  """get_agent for the drift-corrected D-dopant vision planner ('image'
  observations, anchor_order='position', include_fov=True)."""

  num_dopants: int
  dwell_seconds: float = 5.0

  def __call__(self, device):
    return drift_correction.DriftCorrectedMultiDopantVisionPlannerAgent(
        rate_fn=rates_lib.simple_canonical_rates,
        num_dopants=self.num_dopants,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=2.0 * BOND,
        device=device,
    )


def _vector_env(num_dopants, observation_mode='vector'):
  return functools.partial(
      _make_multi_dopant_env, num_dopants=num_dopants,
      observation_mode=observation_mode)


def _vision_env(num_dopants, **drift):
  # anchor_order='position' makes the peak <-> goal association observable
  # from the image alone; 256^2 is the detector's training size.
  return functools.partial(
      _make_multi_dopant_env, num_dopants=num_dopants,
      observation_mode='image', anchor_order='position', image_size=256,
      **drift)


# 0.5 A per frame per axis, cumulative, and the believed FOV in the
# observations for the corrector.
_DRIFT = dict(drift_per_frame_angstroms=0.5, include_fov=True)

_MULTI_DOPANT_EXPERIMENTS = {
    'multi_dopant_2_ppo': MultiDopantExperiment(
        make_env=_vector_env(2),
        get_agent=_checkpoint_agent('multi_dopant_2'),
        num_dopants=2,
    ),
    'multi_dopant_2_random': MultiDopantExperiment(
        make_env=_vector_env(2), num_dopants=2),
    'multi_dopant_3_random': MultiDopantExperiment(
        make_env=_vector_env(3), num_dopants=3),
    'multi_dopant_3_ppo': MultiDopantExperiment(
        make_env=_vector_env(3),
        get_agent=_checkpoint_agent('multi_dopant_3'),
        num_dopants=3,
    ),
    # Rate-aware planner on the D-dopant env, no training.
    **{
        f'multi_dopant_{d}_planner': MultiDopantExperiment(
            make_env=_vector_env(d, 'vector_neighbors'),
            get_agent=_MultiDopantPlannerFactory(num_dopants=d),
            num_dopants=d,
        )
        for d in (2, 3, 4)
    },
    'multi_dopant_4_random': MultiDopantExperiment(
        make_env=_vector_env(4, 'vector_neighbors'), num_dopants=4),
    # The multi-dopant planner distilled into MLPs, over the same
    # 'vector_neighbors' observations the planner consumes.
    **{
        f'multi_dopant_{d}_distilled': MultiDopantExperiment(
            make_env=_vector_env(d, 'vector_neighbors'),
            get_agent=_checkpoint_agent(f'multi_dopant_{d}_distilled'),
            num_dopants=d,
        )
        for d in (2, 3)
    },
    # Pixels to control for D dopants: shipped UNet -> per-dopant peaks ->
    # anchor geometry -> planner.
    **{
        f'multi_dopant_{d}_vision_planner': MultiDopantExperiment(
            make_env=_vision_env(d),
            get_agent=_MultiDopantVisionPlannerFactory(num_dopants=d),
            num_dopants=d,
        )
        for d in (2, 3)
    },
    # The full stress config: multi-dopant lattice, long-horizon KMC,
    # instrument drift and the whole image pipeline, uncorrected and with
    # the in-loop corrector (phase correlation of detector maps + goal
    # snapping).
    'multi_dopant_2_vision_planner_drift': MultiDopantExperiment(
        make_env=_vision_env(2, **_DRIFT),
        get_agent=_MultiDopantVisionPlannerFactory(num_dopants=2),
        num_dopants=2,
    ),
    'multi_dopant_2_vision_planner_drift_corrected': MultiDopantExperiment(
        make_env=_vision_env(2, **_DRIFT),
        get_agent=_MultiDopantDriftCorrectedVisionPlannerFactory(
            num_dopants=2),
        num_dopants=2,
    ),
}


def create_multi_dopant_experiment(name: str) -> MultiDopantExperiment:
  if name not in _MULTI_DOPANT_EXPERIMENTS:
    raise ValueError(f'Unknown multi-dopant experiment {name}.')
  return _MULTI_DOPANT_EXPERIMENTS[name]


def multi_dopant_experiment_names():
  return tuple(_MULTI_DOPANT_EXPERIMENTS)


# -------------------- microscope experiments ----------------------------------


def _microscope_learned_planner(rng, adapters_and_goal, device=None):
  """The planner over the shipped distilled neural rate model; on real
  hardware the planning model is the learned rate predictor."""
  del rng
  return _learned_planner_agent(adapters_and_goal, device)


def _greedy(argmax):
  return functools.partial(_greedy_agent, argmax=argmax)


_MICROSCOPE_EXPERIMENTS = {
    'relative_random': MicroscopeExperiment(
        get_agent=_relative_random_agent,
        get_adapters_and_goal=_single_silicon_goal_reaching,
    ),
    'relative_random_long': MicroscopeExperiment(
        get_agent=_relative_random_agent,
        get_adapters_and_goal=functools.partial(
            _single_silicon_goal_reaching, 1.0, 5.0, 2 * BOND),
    ),
    'relative_random_extra_long': MicroscopeExperiment(
        get_agent=_relative_random_agent,
        get_adapters_and_goal=functools.partial(
            _single_silicon_goal_reaching, 1.0, 5.0, 3 * BOND),
    ),
    **{
        name: MicroscopeExperiment(
            get_agent=_greedy(argmax), get_adapters_and_goal=_material_frame)
        for name, argmax in (
            ('greedy_on_neighbor', (1.42, 0.0)),
            ('greedy_short_of_neighbor', (0.58, 0.0)),
            ('greedy_on_neighbor_offset_horizontally', (1.42, 0.42)),
            ('greedy_from_learned_rates_v3', (1.8686869, 0.0)),
            ('greedy_from_learned_rates_v5', (2.1717172, -0.15151516)),
        )
    },
    'planner_learned_rates': MicroscopeExperiment(
        get_agent=_microscope_learned_planner,
        get_adapters_and_goal=_material_frame,
    ),
    'ppo_simple_images_tf': MicroscopeExperiment(
        get_agent=PolicyCheckpointAgent('ppo_simple_images_tf'),
        get_adapters_and_goal=_single_silicon_from_pixels,
    ),
    # The shipped vector checkpoints on the adapters of their zoo entries.
    **{
        name: MicroscopeExperiment(
            get_agent=PolicyCheckpointAgent(checkpoint),
            get_adapters_and_goal=functools.partial(
                _single_silicon_goal_reaching, *adapter),
        )
        for name, (checkpoint, adapter) in _ZOO.items()
    },
}


def create_microscope_experiment(name: str) -> MicroscopeExperiment:
  if name not in _MICROSCOPE_EXPERIMENTS:
    raise ValueError(f'Unknown microscope experiment {name}.')
  return _MICROSCOPE_EXPERIMENTS[name]


def microscope_experiment_names():
  return tuple(_MICROSCOPE_EXPERIMENTS)
