"""Recorded trajectories -> adjacent-observation transitions, in memory.

Port of `trajectories_to_transitions` of
putting_dune_tpu/pipeline/trajectories_to_transitions.py, with its
controls-attribution flag: simulator recordings carry the controls that
produced the observation (s_t, a_{t-1}); real-microscope recordings carry
the controls issued at it (s_t, a_t). The JAX package's `main` reads and
writes record files, which wait for the protobuf wire codec.
"""

from __future__ import annotations

from typing import List

from putting_dune_torch import microscope_data as md


def trajectories_to_transitions(
    trajectories: List[md.Trajectory],
    *,
    previous_controls_at_current_timestep: bool = False,
) -> List[md.Transition]:
  """Pairs each observation with its successor."""
  transitions = []
  for trajectory in trajectories:
    prev = None
    prev_controls = None
    for obs in trajectory.observations:
      if prev is not None:
        controls = (obs.controls if previous_controls_at_current_timestep
                    else prev_controls)
        transitions.append(md.Transition(
            grid_before=prev.grid,
            grid_after=obs.grid,
            fov_before=prev.fov,
            fov_after=obs.fov,
            controls=tuple(controls or ()),
            image_before=prev.image,
            image_after=obs.image,
            label_image_before=prev.label_image,
            label_image_after=obs.label_image,
        ))
      prev = obs
      prev_controls = obs.controls
  return transitions
