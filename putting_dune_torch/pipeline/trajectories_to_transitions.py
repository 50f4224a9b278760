"""Recorded trajectories -> adjacent-observation transitions.

Port of putting_dune_tpu/pipeline/trajectories_to_transitions.py, with its
controls-attribution flag: simulator recordings carry the controls that
produced the observation (s_t, a_{t-1}); real-microscope recordings carry
the controls issued at it (s_t, a_t). The CLI reads and writes record
files, and its output is byte for byte the JAX package's:

  python -m putting_dune_torch.pipeline.trajectories_to_transitions \\
      --source_path=in.tfrecords --target_path=out.tfrecords
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from putting_dune_torch import microscope_data as md
from putting_dune_torch.io import records


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


def _parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--source_path', required=True)
  parser.add_argument('--target_path', required=True)
  parser.add_argument('--previous_controls_at_current_timestep',
                      action='store_true')
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
  """Runs the CLI; returns the number of transitions written."""
  args = _parse_args(argv)
  trajectories = records.read_records(args.source_path, md.Trajectory)
  transitions = trajectories_to_transitions(
      trajectories, previous_controls_at_current_timestep=(
          args.previous_controls_at_current_timestep))
  records.write_records(args.target_path, transitions)
  print(f'Wrote {len(transitions)} transitions to {args.target_path}')
  return len(transitions)


if __name__ == '__main__':
  main()
