"""Applies the learned ImageAligner over recorded trajectories.

Port of putting_dune_tpu/pipeline/align_trajectories.py: per trajectory,
the aligner's predicted drifts accumulate into FOV corrections, with an
optional multi-pass step-size schedule and relabelling. The CLI reads and
writes record files (`.tfrecords` or `.riegeli`):

  python -m putting_dune_torch.pipeline.align_trajectories \\
      --source_path=in.tfrecords --target_path=out.tfrecords \\
      --aligner_workdir=putting_dune_tpu/experiments/model_weights/image_aligner \\
      [--device=cpu]

The aligner runs on the card unless `--device=cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np

from putting_dune_torch import microscope_data as md
from putting_dune_torch.image_alignment import inference as aligner_lib
from putting_dune_torch.io import records
from putting_dune_torch.utils import cli as cli_lib


@dataclasses.dataclass
class Args:
  """The JAX package's fields, all three paths required, and the device."""

  source_path: str
  target_path: str
  aligner_workdir: str
  history_length: int = 5
  alignment_iterations: int = 1
  base_step_size: float = 1.0
  hybrid: bool = False
  relabel: bool = False
  device: Optional[str] = None


def do_alignment(
    trajectory: md.Trajectory,
    args: Args,
    aligner: aligner_lib.ImageAligner,
) -> md.Trajectory:
  """Aligns one trajectory, accumulating FOV drift corrections."""
  n_iters = args.alignment_iterations
  for i in range(1, n_iters + 1):
    aligned = []
    cumulative_shift = np.zeros(2)
    step_size = args.base_step_size + (1 - args.base_step_size) * i / n_iters
    aligner.reset()
    for obs in trajectory.observations:
      shifted_fov = obs.fov.shift(-cumulative_shift)
      extracted_grid, new_shift, _ = aligner(obs.image, shifted_fov)
      # The aligner predicts the true view's drift relative to the claimed
      # FOV (truth - claim), so the correction moves the claim toward the
      # prediction: subtracting here makes fov.shift(-cumulative) add the
      # recovered drift. Adding it would double the residual every frame.
      cumulative_shift = cumulative_shift - new_shift * step_size
      shifted_fov = obs.fov.shift(-cumulative_shift)
      # The corrected claim goes back into the aligner's history, and the
      # surviving history claims are re-measured from this stack's heads.
      aligner.amend_last_fov(shifted_fov)
      aligner.refine_history_claims()
      aligned.append(md.MicroscopeObservation(
          grid=extracted_grid if args.relabel else obs.grid,
          fov=shifted_fov,
          controls=obs.controls,
          elapsed_time=obs.elapsed_time,
          image=obs.image,
          label_image=obs.label_image,
      ))
    trajectory = md.Trajectory(tuple(aligned))
  return trajectory


def main(args: Args) -> None:
  trajectories = records.read_records(args.source_path, md.Trajectory)
  aligner = aligner_lib.ImageAligner.from_checkpoint(
      args.aligner_workdir, history_length=args.history_length,
      hybrid=args.hybrid, device=args.device)
  aligned = [do_alignment(t, args, aligner) for t in trajectories]
  records.write_records(args.target_path, aligned)
  print(f'Aligned {len(aligned)} trajectories -> {args.target_path}')


def _parse_args(argv: Optional[Sequence[str]] = None) -> Args:
  parser = argparse.ArgumentParser(description=__doc__)
  for field in dataclasses.fields(Args):
    cli_lib._add_field_arg(parser, field)
  return Args(**vars(parser.parse_args(argv)))


def cli() -> None:
  """Console entry point."""
  main(_parse_args())


if __name__ == '__main__':
  cli()
