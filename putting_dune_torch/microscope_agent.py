"""The real-microscope control loop: the hardware calls the agent.

Port of putting_dune_tpu/microscope_agent.py. Control is inverted against
the RL env: the microscope hands the agent `microscope_data`
observations and asks for the next beam controls. The goal, the 10-dim
material-frame features and the material-frame relative adapter run on the
host over the ragged observation; on `SiliconNotFoundError` the agent asks
for a zero-dwell rescan at (0, 0).

`SimulatedMicroscope` puts the port's batched simulator behind that host
interface (drift, renders and all) with the ground truth a real instrument
never shows, so that the whole loop, with the learned `ImageAligner`
correcting the drift, can be rehearsed before touching hardware.

`MicroscopeAgentLogger` wraps an agent and records each episode's
observations as a Trajectory record file (`trajectories.tfrecords`), with
step and episode CSVs.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime as dt
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import microscope_data as md
from putting_dune_torch import rates as rates_lib
from putting_dune_torch import simulator as simulator_lib
from putting_dune_torch import structures
from putting_dune_torch.env import dm_env_wrapper
from putting_dune_torch.io import records


class HostSingleSiliconGoal:
  """Goal reaching on host observations: a goal atom 0.1-50 A from the
  silicon, reached within half a bond."""

  def __init__(self):
    self.goal_position_material_frame = np.zeros(2)
    self._consecutive_goal_steps = 0
    self.goal_range_angstroms = (0.1, 50.0)

  def reset(self, rng: np.random.Generator,
            obs: md.MicroscopeObservation) -> None:
    si = md.get_single_silicon_position(obs.grid)
    shifted = obs.grid.atom_positions - si
    scale = np.asarray([obs.fov.width, obs.fov.height])
    distances = np.linalg.norm(scale * shifted, axis=1)
    lo, hi = self.goal_range_angstroms
    valid = obs.grid.atom_positions[(distances > lo) & (distances < hi)]
    if valid.shape[0] == 0:
      raise RuntimeError("Couldn't find any valid goals.")
    goal = valid[rng.choice(valid.shape[0])]
    self.goal_position_material_frame = (
        obs.fov.microscope_frame_to_material_frame(goal))
    self._consecutive_goal_steps = 0

  def calculate_reward_and_terminal(
      self, obs: md.MicroscopeObservation) -> Tuple[float, bool, bool]:
    si = md.get_single_silicon_position(obs.grid)
    si_material = obs.fov.microscope_frame_to_material_frame(si)
    goal_distance = np.linalg.norm(
        si_material - self.goal_position_material_frame)
    if goal_distance < 0.5 * constants.CARBON_BOND_DISTANCE_ANGSTROMS:
      self._consecutive_goal_steps += 1
    else:
      self._consecutive_goal_steps = 0
    is_terminal = self._consecutive_goal_steps >= 1
    reward = (constants.GAMMA_PER_SECOND ** obs.elapsed_time.total_seconds()
              if is_terminal else 0.0)
    return reward, is_terminal, False


def host_material_frame_features(
    obs: md.MicroscopeObservation, goal: HostSingleSiliconGoal
) -> np.ndarray:
  """The 10-dim material-frame features: silicon position, its three
  nearest neighbours' deltas and the goal delta, angstroms."""
  grid = obs.fov.microscope_frame_to_material_frame(obs.grid)
  si = md.get_single_silicon_position(grid)
  d = np.linalg.norm(grid.atom_positions - si, axis=1)
  neighbor_idx = np.argsort(d, kind='stable')[1:4]
  deltas = grid.atom_positions[neighbor_idx] - si
  si_micro = md.get_single_silicon_position(obs.grid)
  si_material = obs.fov.microscope_frame_to_material_frame(si_micro)
  goal_delta = goal.goal_position_material_frame - si_material
  return np.concatenate([si, deltas.reshape(-1), goal_delta]).astype(
      np.float32)


def host_relative_material_adapter(
    obs: md.MicroscopeObservation,
    action: np.ndarray,
    dwell_seconds: float = 1.5,
) -> List[md.BeamControl]:
  """The material-frame relative adapter: the beam at the silicon plus
  the action (angstroms), clipped to the FOV."""
  si = md.get_silicon_positions(obs.grid)
  if si.shape != (1, 2):
    raise RuntimeError(f'Expected one silicon; got shape {si.shape}.')
  si_material = obs.fov.microscope_frame_to_material_frame(si.reshape(2))
  target = si_material + np.asarray(action[:2])
  position = np.clip(
      obs.fov.material_frame_to_microscope_frame(target), 0.0, 1.0)
  return [md.BeamControl(position, dt.timedelta(seconds=dwell_seconds))]


class MicroscopeAgent:
  """Drives a registry microscope experiment's agent from host
  observations. `device` is the agent's (CUDA unless asked otherwise)."""

  def __init__(self, rng: np.random.Generator, experiment, device=None):
    adapters_and_goal = experiment.get_adapters_and_goal()
    self.agent = experiment.get_agent(rng, adapters_and_goal, device)
    self.goal = HostSingleSiliconGoal()
    self._dwell_seconds = getattr(
        adapters_and_goal.action_adapter, 'min_dwell_seconds', 1.5)
    self._is_first_step = True

  def reset(self, rng: np.random.Generator,
            observation: md.MicroscopeObservation) -> None:
    self.goal.reset(rng, observation)
    self._is_first_step = True

  def step(self, observation: md.MicroscopeObservation
           ) -> List[md.BeamControl]:
    """The next beam controls for the hardware to apply."""
    try:
      features = host_material_frame_features(observation, self.goal)
      reward, is_terminal, is_truncated = (
          self.goal.calculate_reward_and_terminal(observation))
    except md.SiliconNotFoundError:
      # Rescan: a zero-dwell control at the origin.
      return [md.BeamControl(np.zeros(2), dt.timedelta(seconds=0.0))]

    elapsed = observation.elapsed_time.total_seconds()
    discount = constants.GAMMA_PER_SECOND**elapsed
    if is_terminal:
      time_step = dm_env_wrapper.termination(reward, features)
    elif is_truncated:
      time_step = dm_env_wrapper.truncation(reward, features, discount)
    elif self._is_first_step:
      time_step = dm_env_wrapper.restart(features)
    else:
      time_step = dm_env_wrapper.transition(reward, features, discount)

    action = self.agent.step(time_step)
    self._is_first_step = False
    return host_relative_material_adapter(
        observation, np.asarray(action), self._dwell_seconds)


@dataclasses.dataclass
class StepRecord:
  episode: int
  episode_step: int
  reward: float
  elapsed_seconds: float
  terminal: bool


@dataclasses.dataclass
class EpisodeRecord:
  episode: int
  episode_steps: int
  episode_return: float
  episode_goal: Optional[Tuple[float, float]]


class MicroscopeAgentLogger:
  """Records an agent's episodes: every observation it is given goes into
  the episode's Trajectory, written with the step and episode CSVs on
  `flush()` (or on leaving a `with` block without an error) as
  `logdir`/trajectories.tfrecords, steps.csv and episodes.csv. Everything
  else is the wrapped agent's."""

  def __init__(self, agent: MicroscopeAgent, *, logdir: str):
    self._agent = agent
    self._logdir = logdir
    os.makedirs(logdir, exist_ok=True)
    self._episode = 0
    self._episode_step = 0
    self._episode_return = 0.0
    self._current_trajectory: List[md.MicroscopeObservation] = []
    self._trajectories: List[md.Trajectory] = []
    self._step_records: List[StepRecord] = []
    self._episode_records: List[EpisodeRecord] = []

  def __getattr__(self, name):
    return getattr(self._agent, name)

  def __enter__(self) -> 'MicroscopeAgentLogger':
    return self

  def __exit__(self, exc_type, exc_val, exc_tb):
    if exc_type is None:
      self.flush()

  @property
  def trajectories(self) -> List[md.Trajectory]:
    """The finished episodes' trajectories, in order."""
    return list(self._trajectories)

  def _episode_record(self) -> EpisodeRecord:
    goal = self._agent.goal.goal_position_material_frame
    return EpisodeRecord(
        episode=self._episode,
        episode_steps=self._episode_step,
        episode_return=self._episode_return,
        episode_goal=(float(goal[0]), float(goal[1])),
    )

  def reset(self, rng, observation) -> None:
    if self._episode_step > 0:
      self._episode += 1
      self._episode_records.append(self._episode_record())
    if self._current_trajectory:
      self._trajectories.append(
          md.Trajectory(tuple(self._current_trajectory)))
    self._episode_step = 0
    self._episode_return = 0.0
    self._current_trajectory = []
    return self._agent.reset(rng, observation)

  def step(self, observation) -> List[md.BeamControl]:
    controls = self._agent.step(observation)
    try:
      reward, terminal, _ = self._agent.goal.calculate_reward_and_terminal(
          observation)
    except md.SiliconNotFoundError:
      reward, terminal = 0.0, False
    self._episode_step += 1
    self._episode_return += reward
    self._current_trajectory.append(observation)
    self._step_records.append(StepRecord(
        episode=self._episode,
        episode_step=self._episode_step,
        reward=reward,
        elapsed_seconds=observation.elapsed_time.total_seconds(),
        terminal=terminal,
    ))
    return controls

  def flush(self) -> None:
    if self._current_trajectory:
      self._trajectories.append(
          md.Trajectory(tuple(self._current_trajectory)))
      self._current_trajectory = []
    if self._episode_step != 0:
      self._episode_records.append(self._episode_record())
    records.write_records(
        os.path.join(self._logdir, 'trajectories.tfrecords'),
        self._trajectories)
    for name, rows, cls in (
        ('steps.csv', self._step_records, StepRecord),
        ('episodes.csv', self._episode_records, EpisodeRecord),
    ):
      with open(os.path.join(self._logdir, name), 'w', newline='') as f:
        writer = csv.DictWriter(
            f, fieldnames=[fld.name for fld in dataclasses.fields(cls)])
        writer.writeheader()
        for row in rows:
          writer.writerow(dataclasses.asdict(row))


class SimulatedMicroscope:
  """The drifting batched simulator behind the host interface of a STEM.

  reset() and apply(controls) hand back MicroscopeObservations built from
  what the instrument would measure: the drifted view's atoms in the
  believed FOV's microscope frame, and the rendered frame when image_size
  is set. The draws come from one seeded torch.Generator on `device`
  (CUDA unless asked otherwise). `true_silicon_position` and `true_drift`
  expose the sample-frame truth.
  """

  def __init__(
      self,
      *,
      seed: int = 0,
      grid_columns: int = 50,
      drift_per_frame_angstroms: float = 0.0,
      image_size: Optional[int] = None,
      rate_fn=None,
      device=None,
  ):
    self.device = device_lib.resolve_device(device)
    self._lattice = lattice_lib.make_lattice(grid_columns, self.device)
    self._config = simulator_lib.SimulatorConfig(
        grid_columns=grid_columns,
        image_size=image_size or 128,
        drift_per_frame_angstroms=drift_per_frame_angstroms,
    )
    self._with_image = image_size is not None
    self._rate_fn = rate_fn or rates_lib.simple_canonical_rates
    self._gen = torch.Generator(device=self.device)
    self._gen.manual_seed(int(seed))
    self._state = None

  def _assert_has_been_reset(self, fn_name: str) -> None:
    if self._state is None:
      raise RuntimeError(
          f'SimulatedMicroscope.{fn_name}() called before reset(); the '
          'instrument must be reset first.')

  def _host_observation(
      self, obs, controls: Tuple[md.BeamControl, ...] = ()
  ) -> md.MicroscopeObservation:
    # The applied controls ride along in the post-step observation, so a
    # recorded trajectory feeds trajectories_to_transitions.
    return md.observation_from_device(
        obs.window, obs.fov, obs.elapsed_seconds, controls=controls,
        image=obs.image if self._with_image else None)

  def reset(self) -> md.MicroscopeObservation:
    with torch.inference_mode():
      self._state, obs = simulator_lib.reset(
          self._gen, self._lattice, config=self._config, batch_size=1,
          return_window=True, return_image=self._with_image)
    return self._host_observation(obs)

  def apply(self, controls: List[md.BeamControl]
            ) -> md.MicroscopeObservation:
    """Applies the single control (one beam a frame) and re-images; more
    than one control raises rather than dropping any."""
    self._assert_has_been_reset('apply')
    if len(controls) != 1:
      raise ValueError(
          'SimulatedMicroscope models a single beam control per frame; '
          f'got {len(controls)} controls.')
    control = controls[0]
    device_control = structures.BeamControl(
        position=torch.tensor(
            np.asarray(control.position, np.float32).reshape(1, 2),
            device=self.device),
        dwell_seconds=torch.tensor(
            [control.dwell_time.total_seconds()], dtype=torch.float32,
            device=self.device),
    )
    with torch.inference_mode():
      self._state, obs, _ = simulator_lib.step(
          self._state, self._gen, device_control, self._lattice,
          self._rate_fn, config=self._config, return_window=True,
          return_image=self._with_image)
    # A copy of what was applied: the caller owns the control's buffer.
    recorded = md.BeamControl(
        np.asarray(control.position, dtype=float).copy(), control.dwell_time,
        voltage_kv=control.voltage_kv, current_na=control.current_na)
    return self._host_observation(obs, controls=(recorded,))

  # Ground truth the real instrument never shows (rehearsal metrics).

  def true_silicon_position(self) -> np.ndarray:
    self._assert_has_been_reset('true_silicon_position')
    material = self._state.material
    return lattice_lib.site_position(
        self._lattice, material.si_index, material.offset, material.theta
    )[0].cpu().numpy()

  def true_drift(self) -> np.ndarray:
    self._assert_has_been_reset('true_drift')
    return self._state.drift[0].cpu().numpy()


def drifting_sequence(
    seed: int, frames: int = 12, device=None
) -> Tuple[List[md.MicroscopeObservation], np.ndarray]:
  """(observations, true cumulative drifts (frames, 2)) of a microscope
  drifting 0.5 A per frame whose silicon does not move (rates of 1e-12),
  128^2 renders, a fixed 1.5 s beam at (0.5, 0.5): the sequence the JAX
  package's test_learned_aligner_recovers_simulated_drift aligns."""
  microscope = SimulatedMicroscope(
      seed=seed, drift_per_frame_angstroms=0.5, image_size=128,
      device=device,
      rate_fn=lambda si, nbr, beam: torch.full(si.shape[:-1] + (3,), 1e-12,
                                               device=si.device))
  observations = [microscope.reset()]
  drifts = [microscope.true_drift()]
  control = md.BeamControl(np.full(2, 0.5), dt.timedelta(seconds=1.5))
  for _ in range(frames - 1):
    observations.append(microscope.apply([control]))
    drifts.append(microscope.true_drift())
  return observations, np.stack(drifts)


def rehearse(
    microscope: SimulatedMicroscope,
    agent: MicroscopeAgent,
    rng: np.random.Generator,
    aligner=None,
    steps: int = 35,
) -> Tuple[float, float]:
  """Runs the hardware loop for `steps` steps from a reset: the agent acts
  on each observation, through `aligner` (an ImageAligner) correcting the
  FOV claims when given. Returns the closest and the final distance,
  angstroms, of the true silicon to the goal chosen at reset (where the
  drift is 0, so the believed and the true frame agree)."""
  obs = microscope.reset()
  agent.reset(rng, obs)
  goal = agent.goal.goal_position_material_frame.copy()
  cumulative = np.zeros(2)
  if aligner is not None:
    aligner.reset()
  closest = np.inf
  for _ in range(steps):
    if aligner is not None:
      _, new_shift, _ = aligner(obs.image, obs.fov.shift(-cumulative))
      cumulative = cumulative - new_shift
      fixed_fov = obs.fov.shift(-cumulative)
      aligner.amend_last_fov(fixed_fov)
      aligner.refine_history_claims()
      obs = md.MicroscopeObservation(
          grid=obs.grid, fov=fixed_fov, controls=obs.controls,
          elapsed_time=obs.elapsed_time)
    obs = microscope.apply(agent.step(obs))
    closest = min(closest, float(np.linalg.norm(
        microscope.true_silicon_position() - goal)))
  final = float(np.linalg.norm(microscope.true_silicon_position() - goal))
  return closest, final
