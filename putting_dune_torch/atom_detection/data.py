"""Training data for atom detection, generated on the device.

Port of putting_dune_tpu/atom_detection/data.py `sample_batch` and
`dataset_iterator`: every batch is a fresh domain-randomized scene from
the simulator, rendered (splat -> noise chain -> CLAHE) and labelled
(0 background, 1 carbon, 2 silicon) on the device. The record-backed
dataset source (`write_dataset`, `records_dataset_iterator`) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import simulator as simulator_lib
from putting_dune_torch.imaging import render as render_lib

# Class ids: 0 background, 1 carbon, 2 silicon.
NUM_CLASSES = 3


def sample_batch(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    *,
    batch_size: int = 8,
    image_size: int = 128,
    noisy: bool = False,
) -> Dict[str, torch.Tensor]:
  """One batch of {image (B,S,S,1), mask (B,S,S,3)} fresh scenes, on the
  lattice's device."""
  config = simulator_lib.SimulatorConfig(
      image_size=image_size, noisy_images=noisy
  )
  with torch.no_grad():
    state, obs = simulator_lib.reset(
        gen, lattice, config=config, batch_size=batch_size,
        return_window=True,
    )
    image = render_lib.render_stem_image(
        gen, obs.window, state.fov, state.imaging, image_size=image_size
    )
    labels = render_lib.render_label_mask(
        obs.window, state.fov,
        intensity_exponent=state.imaging.intensity_exponent,
        image_size=image_size,
    )
    class_ids = torch.where(
        labels == constants.SILICON, 2,
        torch.where(labels == constants.CARBON, 1, 0),
    )
    mask = F.one_hot(class_ids, NUM_CLASSES).to(torch.float32)
  return {'image': image[..., None], 'mask': mask}


def dataset_iterator(
    seed: int,
    *,
    batch_size: int = 8,
    image_size: int = 128,
    grid_columns: int = 50,
    noisy: bool = False,
    noisy_fraction: Optional[float] = None,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
  """Endless stream of freshly generated batches.

  noisy_fraction, when set, overrides `noisy` with a per-batch Bernoulli
  draw (deterministic from seed): each batch is rendered fully noisy with
  that probability and clean otherwise. `device` defaults to CUDA and
  raises if it is absent unless device='cpu'.
  """
  device = device_lib.resolve_device(device)
  lattice = lattice_lib.make_lattice(grid_columns, device)
  gen = torch.Generator(device=device).manual_seed(seed)
  mix_rng = np.random.default_rng(seed) if noisy_fraction is not None else None
  while True:
    batch_noisy = (
        bool(mix_rng.random() < noisy_fraction) if mix_rng is not None
        else noisy
    )
    yield sample_batch(
        gen, lattice, batch_size=batch_size, image_size=image_size,
        noisy=batch_noisy,
    )
