"""Synthetic point-cloud stacks for graph-alignment training, on the
device.

Port of putting_dune_tpu/graph_alignment/data.py `sample_batch` and
`dataset_iterator`: T observations of one lattice pose whose field of view
drifts by a per-step U(-max_drift_per_step, max_drift_per_step) per axis
(frame 0 undrifted), each atom jittered by N(0, jitter_scale^2) per frame,
positions in the undrifted material frame, a fixed node capacity per
frame and a mask. Labels are each frame's drift less the final frame's.
No kernel runs here. The record-backed source waits for the IO slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

import torch

from putting_dune_torch import device as device_lib
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import simulator as simulator_lib


def sample_batch(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    *,
    batch_size: int = 8,
    num_frames: int = 2,
    capacity: int = 256,
    max_drift_per_step: float = 1.0,
    jitter_scale: float = 0.05,
) -> Dict[str, torch.Tensor]:
  """{positions (B, T K, 2), atomic_numbers (B, T K) int32, mask (B, T K),
  frame_ids (B, T K) int32, drift (B, T, 2)} on the lattice's device."""
  b, dev = batch_size, lattice.device
  config = simulator_lib.SimulatorConfig(window_capacity=capacity)
  with torch.no_grad():
    state, _ = simulator_lib.reset(gen, lattice, config=config, batch_size=b)
    steps = (torch.rand((b, num_frames, 2), generator=gen, device=dev)
             * 2.0 - 1.0) * max_drift_per_step
    steps[:, 0] = 0.0
    cumulative = torch.cumsum(steps, dim=1)
    extent = state.fov.upper_right - state.fov.lower_left
    positions, numbers, masks = [], [], []
    for t in range(num_frames):
      window = simulator_lib.atom_window(
          lattice, state.material, state.fov.shift(cumulative[:, t]),
          capacity)
      # Positions in the estimated (undrifted) material frame: the window
      # is read back through the original field of view.
      pos = window.positions * extent[:, None] + state.fov.lower_left[:, None]
      jitter = torch.randn(pos.shape, generator=gen, device=dev)
      positions.append(torch.where(window.mask[..., None],
                                   pos + jitter * jitter_scale, 0.0))
      numbers.append(window.atomic_numbers)
      masks.append(window.mask)
    frame_ids = torch.arange(num_frames, dtype=torch.int32, device=dev)
    frame_ids = frame_ids.repeat_interleave(capacity)[None].expand(b, -1)
    return {
        'positions': torch.cat(positions, dim=1),
        'atomic_numbers': torch.cat(numbers, dim=1),
        'mask': torch.cat(masks, dim=1),
        'frame_ids': frame_ids.contiguous(),
        'drift': cumulative - cumulative[:, -1:],
    }


def dataset_iterator(
    seed: int,
    *,
    batch_size: int = 8,
    num_frames: int = 2,
    capacity: int = 256,
    grid_columns: int = 50,
    max_drift_per_step: float = 1.0,
    jitter_scale: float = 0.05,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
  """Endless stream of point-cloud batches on `device` (CUDA unless
  'cpu')."""
  device = device_lib.resolve_device(device)
  lattice = lattice_lib.make_lattice(grid_columns, device)
  gen = torch.Generator(device=device).manual_seed(seed)
  while True:
    yield sample_batch(
        gen, lattice, batch_size=batch_size, num_frames=num_frames,
        capacity=capacity, max_drift_per_step=max_drift_per_step,
        jitter_scale=jitter_scale)
