"""Simulator event recording.

Port of putting_dune_tpu/simulator_observers.py. The simulator returns
its event data (the KMC event log in `kmc.KMCResult`, the observations)
instead of calling observers; `EventObserver` turns those returns into the
RESET / FOV_CHANGE / APPLY_CONTROL / TRANSITION / TAKE_IMAGE /
GENERATED_IMAGE event stream of one environment of the batch, for videos
and eval debugging. Tensors are read back to host arrays.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List

import numpy as np


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)


@enum.unique
class SimulatorEventType(enum.Enum):
  RESET = 'reset'
  TRANSITION = 'transition'
  APPLY_CONTROL = 'apply_control'
  TAKE_IMAGE = 'take_image'
  GENERATED_IMAGE = 'generated_image'
  FOV_CHANGE = 'fov_change'


@dataclasses.dataclass(frozen=True)
class SimulatorEvent:
  event_type: SimulatorEventType
  data: Any


class EventObserver:
  """Collects simulator events for a single environment (batch index 0).

  Usage: call the record_* methods with the outputs of simulator
  reset/step (`simulator.step(..., record_events=E)` for the
  transitions); read .events.
  """

  def __init__(self, batch_index: int = 0):
    self.events: List[SimulatorEvent] = []
    self._b = batch_index

  def reset(self) -> None:
    self.events = []

  def record_reset(self, state, obs) -> None:
    b = self._b
    self.events.append(
        SimulatorEvent(
            SimulatorEventType.RESET,
            {
                'offset': _host(state.material.offset)[b],
                'theta': float(_host(state.material.theta)[b]),
                'si_index': int(_host(state.material.si_index)[b]),
                'fov_lower_left': _host(state.fov.lower_left)[b],
                'fov_upper_right': _host(state.fov.upper_right)[b],
            },
        )
    )
    self.events.append(
        SimulatorEvent(
            SimulatorEventType.FOV_CHANGE,
            {
                'lower_left': _host(state.fov.lower_left)[b],
                'upper_right': _host(state.fov.upper_right)[b],
            },
        )
    )

  def record_step(
      self, state, obs, kmc_result, control=None
  ) -> None:
    b = self._b
    if control is not None:
      self.events.append(
          SimulatorEvent(
              SimulatorEventType.APPLY_CONTROL,
              {
                  'position': _host(control.position)[b],
                  'dwell_seconds': float(
                      _host(control.dwell_seconds)[b]
                  ),
              },
          )
      )
    times = _host(kmc_result.event_times)[:, b]
    sites = _host(kmc_result.event_sites)[:, b]
    for t, site in zip(times, sites):
      if site >= 0 and np.isfinite(t):
        self.events.append(
            SimulatorEvent(
                SimulatorEventType.TRANSITION,
                {'time_since_control': float(t), 'si_index': int(site)},
            )
        )
    self.events.append(
        SimulatorEvent(
            SimulatorEventType.TAKE_IMAGE,
            {
                'fov_lower_left': _host(state.fov.lower_left)[b],
                'fov_upper_right': _host(state.fov.upper_right)[b],
            },
        )
    )
    if obs.image is not None:
      self.events.append(
          SimulatorEvent(
              SimulatorEventType.GENERATED_IMAGE,
              {'image': _host(obs.image)[b]},
          )
      )
