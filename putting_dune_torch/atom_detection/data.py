"""Training data for atom detection, generated on the device.

Port of putting_dune_tpu/atom_detection/data.py `sample_batch` and
`dataset_iterator`: every batch is a fresh domain-randomized scene from
the simulator, rendered (splat -> noise chain -> CLAHE) and labelled
(0 background, 1 carbon, 2 silicon) on the device. `write_dataset`
materialises such scenes as a record dataset (`io/datasets.py`; one
{'image': (S, S, 1) f32, 'mask': (S, S, 3) f32} example a record, the JAX
package's schema) and `records_dataset_iterator` reads one back, written
by either package.
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
from putting_dune_torch.io import datasets

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


# --- record-backed dataset source --------------------------------------------


def write_dataset(
    records_dir: str,
    *,
    num_examples: int,
    seed: int = 0,
    gen_batch_size: int = 64,
    image_size: int = 128,
    grid_columns: int = 50,
    noisy: bool = False,
    noisy_fraction: Optional[float] = None,
    test_examples: int = 0,
    examples_per_shard: int = 256,
    device=None,
) -> int:
  """Renders scenes on `device` and writes them as TFRecord shards;
  returns the number of train examples written. With test_examples > 0 a
  held-out `test/` split comes from the stream seed + 1. The dataset is
  staged and published whole (`io/datasets.write_split_dataset`)."""

  def batches(stream: int):
    return dataset_iterator(
        seed + stream, batch_size=gen_batch_size, image_size=image_size,
        grid_columns=grid_columns, noisy=noisy,
        noisy_fraction=noisy_fraction, device=device)

  return datasets.write_generated(
      records_dir, batches, num_examples=num_examples,
      test_examples=test_examples, examples_per_shard=examples_per_shard)


def records_dataset_iterator(
    records_dir: str,
    seed: int,
    *,
    batch_size: int,
    split: str = 'train',
    shuffle: bool = True,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
  """Endless {'image', 'mask'} batches of a written dataset on `device`,
  in place of `dataset_iterator`; batch_size is per process."""
  return datasets.split_batches(records_dir, seed, batch_size=batch_size,
                                split=split, shuffle=shuffle, device=device)
