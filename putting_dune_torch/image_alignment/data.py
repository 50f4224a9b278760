"""Drifting frame-stack data for alignment training, generated on the
device.

Port of putting_dune_tpu/image_alignment/data.py `sample_stack`,
`dataset_iterator` and `examples_from_labeled_trajectory`. A fixed scene
is imaged T times while the field of view moves; each frame goes through
the renderer (splat, the noise chain kernel, CLAHE: `clahe_small` at
128^2) and gets its class mask. Two protocols:

  * raw drifting stacks (registration_noise 0): per-step drift
    U(-max_drift_per_step, max_drift_per_step) per axis, frame 0
    undrifted, labels the cumulative offsets;
  * inference-matched (registration_noise > 0): history frames carry a
    claim residual U(-registration_noise, registration_noise), the final
    frame one step of drift; a `seed_fraction` of the samples copy frame 0
    into the history (the aligner's self-seeded first window); history
    frames get zero-filled pad-and-crop borders up to (T - 1 - t) steps
    wide, their mask set to background there. Labels are the offsets.

With `inference_preprocessing` every frame is equalized a second time and
min-max normalized, as `ImageAligner.__call__` sees it.

The PRNG streams differ from the JAX package's (Philox against threefry),
so the two agree in law; `tests/test_torch_perception_train.py` holds them
to each other by KS and z-tests. The record-backed source waits for the
IO slice.
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
from putting_dune_torch import structures
from putting_dune_torch.atom_detection import data as det_data
from putting_dune_torch.imaging import clahe as clahe_lib
from putting_dune_torch.imaging import morphology
from putting_dune_torch.imaging import render as render_lib


def _min_max(frame: torch.Tensor) -> torch.Tensor:
  lo = torch.amin(frame, dim=(1, 2), keepdim=True)
  hi = torch.amax(frame, dim=(1, 2), keepdim=True)
  return (frame - lo) / torch.clamp(hi - lo, min=1e-12)


def sample_stack(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    *,
    batch_size: int = 4,
    image_size: int = 128,
    num_frames: int = 5,
    noisy: bool = False,
    max_drift_per_step: float = 1.0,
    registration_noise: float = 0.0,
    inference_preprocessing: bool = False,
    seed_fraction: float = 0.0,
) -> Dict[str, torch.Tensor]:
  """One batch on the lattice's device: {images (B, S, S, T), mask
  (B, S, S, 3 T) frame-major, drift (B, T, 2)}."""
  b, s, t_frames = batch_size, image_size, num_frames
  dev = lattice.device
  config = simulator_lib.SimulatorConfig(image_size=s, noisy_images=noisy)

  def uniform(shape, bound):
    return (torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0) * bound

  with torch.no_grad():
    state, _ = simulator_lib.reset(gen, lattice, config=config,
                                   batch_size=b)
    if registration_noise > 0:
      hist = uniform((b, t_frames - 1, 2), registration_noise)
      seeded = torch.rand((b,), generator=gen, device=dev) < seed_fraction
      hist = torch.where(seeded[:, None, None], 0.0, hist)
      final = uniform((b, 1, 2), max_drift_per_step)
      offsets = torch.cat([hist, final], dim=1)
    else:
      steps = uniform((b, t_frames, 2), max_drift_per_step)
      steps[:, 0] = 0.0
      offsets = torch.cumsum(steps, dim=1)
      seeded = torch.zeros((b,), dtype=torch.bool, device=dev)

    px_per_ang = s / (state.fov.upper_right - state.fov.lower_left)  # (B, 2)
    iota = torch.arange(s, device=dev, dtype=torch.float32)
    rows, cols = iota[None, :, None], iota[None, None, :]
    background = F.one_hot(torch.zeros((), dtype=torch.long, device=dev),
                           det_data.NUM_CLASSES).float()
    frames, masks = [], []
    for t in range(t_frames):
      fov_t = state.fov.shift(offsets[:, t])
      window = simulator_lib.atom_window(lattice, state.material, fov_t,
                                         config.window_capacity)
      frame = render_lib.render_stem_image(gen, window, fov_t, state.imaging,
                                           image_size=s)
      labels = render_lib.render_label_mask(
          window, fov_t, intensity_exponent=state.imaging.intensity_exponent,
          image_size=s)
      class_ids = torch.where(
          labels == constants.SILICON, 2,
          torch.where(labels == constants.CARBON, 1, 0))
      mask_t = F.one_hot(class_ids.long(), det_data.NUM_CLASSES).float()
      if inference_preprocessing:
        frame = _min_max(clahe_lib.equalize_adapthist(frame))
      if registration_noise > 0 and t < t_frames - 1:
        if t > 0:
          frame = torch.where(seeded[:, None, None], frames[0], frame)
          mask_t = torch.where(seeded[:, None, None, None], masks[0], mask_t)
        bmax = (t_frames - 1 - t) * max_drift_per_step
        beta = uniform((b, 2), bmax)
        beta = torch.where(seeded[:, None], 0.0, beta)
        bpx = beta * px_per_ang
        bx, by = bpx[:, 0, None, None], bpx[:, 1, None, None]
        # Row 0 is the top (max y): a query right of the claim blanks a
        # band on the right, a query above it a band on top.
        keep = (torch.where(bx >= 0, cols < s - bx, cols >= -bx)
                & torch.where(by >= 0, rows >= by, rows < s + by))
        frame = torch.where(keep, frame, 0.0)
        mask_t = torch.where(keep[..., None], mask_t, background)
      frames.append(frame)
      masks.append(mask_t)
  return {'images': torch.stack(frames, dim=-1),
          'mask': torch.cat(masks, dim=-1),
          'drift': offsets}


def dataset_iterator(
    seed: int,
    *,
    batch_size: int = 4,
    image_size: int = 128,
    num_frames: int = 5,
    grid_columns: int = 50,
    noisy: bool = False,
    noisy_fraction: Optional[float] = None,
    max_drift_per_step: float = 1.0,
    registration_noise: float = 0.0,
    inference_preprocessing: bool = False,
    seed_fraction: float = 0.0,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
  """Endless stream of drifting frame stacks on `device` (CUDA unless
  'cpu'). noisy_fraction, when set, overrides `noisy` with a per-batch
  Bernoulli draw from np.random.default_rng(seed), as in the JAX package."""
  device = device_lib.resolve_device(device)
  lattice = lattice_lib.make_lattice(grid_columns, device)
  gen = torch.Generator(device=device).manual_seed(seed)
  mix_rng = np.random.default_rng(seed) if noisy_fraction is not None else None
  while True:
    batch_noisy = (bool(mix_rng.random() < noisy_fraction)
                   if mix_rng is not None else noisy)
    yield sample_stack(
        gen, lattice, batch_size=batch_size, image_size=image_size,
        num_frames=num_frames, noisy=batch_noisy,
        max_drift_per_step=max_drift_per_step,
        registration_noise=registration_noise,
        inference_preprocessing=inference_preprocessing,
        seed_fraction=seed_fraction)


def examples_from_labeled_trajectory(
    labeled,
    *,
    num_frames: int = 5,
    image_size: int = 128,
    stride: int = 1,
    inference_preprocessing: bool = False,
    device=None,
):
  """Drift-stack train examples from a real labeled trajectory
  (`microscope_data.LabeledAlignmentTrajectory`): each window of
  `num_frames` consecutive observations, every `stride`, becomes one
  example labelled with each frame's drift less the window's first. Real
  data carries no masks, so `mask` is all background (train with
  ce_loss_weight=0).

  Each frame is resized to image_size^2 and min-max normalized: bilinear
  (OpenCV's INTER_LINEAR, `morphology.resize_bilinear`), or with
  `inference_preprocessing` as the aligner preprocesses it, CLAHE at full
  resolution (`equalize_adapthist_padded` on `device`, CUDA unless 'cpu')
  then a nearest-neighbour resize.

  Yields {'images': (S, S, T), 'mask': (S, S, 3 T), 'drift': (T, 2)}
  float32 numpy examples.
  """
  observations = list(labeled.trajectory.observations)
  drifts = list(labeled.drifts)
  if len(drifts) != len(observations):
    raise ValueError(
        f'{len(drifts)} drift labels for {len(observations)} observations')
  if inference_preprocessing:
    device = device_lib.resolve_device(device)
  frames = []
  for obs in observations:
    if obs.image is None:
      raise ValueError('observation without an image cannot be aligned')
    img = np.asarray(obs.image, np.float32)
    if img.ndim == 3:
      img = img[..., 0]
    if inference_preprocessing:
      img = clahe_lib.equalize_adapthist_padded(
          torch.as_tensor(img, device=device)[None])[0].cpu().numpy()
      img = morphology.resize_nearest(img, image_size, image_size)
    else:
      img = morphology.resize_bilinear(img, image_size, image_size)
    lo, hi = float(img.min()), float(img.max())
    frames.append((img - lo) / max(hi - lo, 1e-12))

  background = np.zeros((image_size, image_size, num_frames * 3), np.float32)
  background[..., 0::3] = 1.0
  for start in range(0, len(frames) - num_frames + 1, stride):
    base = drifts[start].drift
    labels = np.stack([np.asarray(drifts[start + t].drift, np.float32) - base
                       for t in range(num_frames)])
    yield {
        'images': np.stack(frames[start:start + num_frames],
                           axis=-1).astype(np.float32),
        'mask': background,
        'drift': labels.astype(np.float32),
    }
