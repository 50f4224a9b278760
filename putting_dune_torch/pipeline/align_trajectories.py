"""Applies the learned ImageAligner over recorded trajectories, in memory.

Port of `Args` and `do_alignment` of
putting_dune_tpu/pipeline/align_trajectories.py: per trajectory, the
aligner's predicted drifts accumulate into FOV corrections, with an
optional multi-pass step-size schedule and relabelling. The JAX package's
`main` reads and writes record files, which wait for the protobuf wire
codec.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from putting_dune_torch import microscope_data as md
from putting_dune_torch.image_alignment import inference as aligner_lib


@dataclasses.dataclass
class Args:
  source_path: str = ''
  target_path: str = ''
  aligner_workdir: str = aligner_lib.SHIPPED_ALIGNER_DIR
  history_length: int = 5
  alignment_iterations: int = 1
  base_step_size: float = 1.0
  hybrid: bool = False
  relabel: bool = False


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
