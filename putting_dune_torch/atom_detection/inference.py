"""Atom detection inference: segmentation -> atom centroids.

Port of putting_dune_tpu/atom_detection/inference.py: the UNet's softmax
on the device, then on the host per-class binary masks (carbon thresholded
at 0.025; silicon at 0.5 and masked by the carbon mask dilated 4 times and
eroded twice), a distance transform scaled to [0, 255] and thresholded,
and the contours' centroids (imaging/morphology.py, what OpenCV gives in
the JAX package), as a microscope-frame AtomicGrid (origin at the bottom
left).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import microscope_data as md
from putting_dune_torch.atom_detection import model as model_lib
from putting_dune_torch.atom_detection import train as train_lib
from putting_dune_torch.imaging import morphology


def compute_centroids(
    mask_image: np.ndarray, value: int, threshold_value: int,
    image_size: int = 256,
) -> List[Tuple[float, float]]:
  """Centroids of the pixels equal to `value`: the distance transform,
  normalised by its peak to [0, 255], thresholded at `threshold_value`,
  and each contour's centroid in the microscope frame."""
  masked = np.zeros_like(mask_image, dtype=np.uint8)
  masked[mask_image == value] = 1
  dists = morphology.distance_transform_l2(masked)
  peak = dists.max()
  if peak > 0:
    dists = dists / peak
  dists = (dists * 255).astype(np.uint8)
  dists = morphology.threshold_binary(dists, threshold_value, 255)
  return [(c_x / image_size, 1.0 - c_y / image_size)
          for c_x, c_y in morphology.contour_centroids(dists)]


class AtomDetector:
  """Detects atoms in STEM frames with a trained UNet.

  device: CUDA unless asked otherwise (device.resolve_device). The
  convolutions run in full float32 (no TF32), so that the card gives the
  CPU's detections.
  """

  def __init__(
      self,
      params,
      *,
      features: Tuple[int, ...] = (32, 64, 128, 256),
      num_classes: int = 3,
      image_size: int = 256,
      device=None,
  ):
    self.device = device_lib.resolve_device(device)
    module = model_lib.UNet(num_classes=num_classes, features=features)
    module.load_state_dict(model_lib.params_from_flax(params))
    self.module = module.to(self.device).eval()
    self._image_size = image_size

  @classmethod
  def from_checkpoint(
      cls, workdir: str, *, features: Tuple[int, ...] = (32, 64, 128, 256),
      image_size: int = 256, **kwargs,
  ) -> 'AtomDetector':
    """Loads `workdir`/params.msgpack; its arch.json, where present, sets
    the feature pyramid."""
    arch = train_lib.load_arch(workdir)
    if arch is not None:
      features = tuple(arch['features'])
    return cls(train_lib.load_params(workdir), features=features,
               image_size=image_size, **kwargs)

  def probabilities(self, image: np.ndarray) -> np.ndarray:
    """Image (H, W[, 1]) -> (S, S, 3) class probabilities (nearest resize,
    min-max normalisation, UNet and softmax on the device)."""
    s = self._image_size
    image = np.asarray(image, np.float32)
    if image.ndim == 3:
      image = image[..., 0]
    image = morphology.resize_nearest(image, s, s)
    lo, hi = image.min(), image.max()
    image = (image - lo) / max(hi - lo, 1e-12)
    x = torch.tensor(image, device=self.device)[None, ..., None]
    with torch.no_grad(), torch.backends.cudnn.flags(
        enabled=True, benchmark=False, allow_tf32=False):
      return torch.softmax(self.module(x), dim=-1)[0].cpu().numpy()

  def __call__(self, image: np.ndarray) -> md.AtomicGrid:
    """Image (H, W[, 1]) -> microscope-frame AtomicGrid of detections."""
    return self.grid_from_probabilities(self.probabilities(image))

  def grid_from_probabilities(self, probs: np.ndarray) -> md.AtomicGrid:
    """(S, S, 3) class probabilities -> microscope-frame AtomicGrid."""
    s = self._image_size
    carbon_bin = morphology.threshold_binary(probs[:, :, 1], 0.025, 1.0)
    dilated = morphology.erode(morphology.dilate(carbon_bin, 4), 2)
    silicon_bin = morphology.threshold_binary(probs[:, :, 2], 0.5, 1.0)
    # Silicon detections overlapping likely carbon are dropped.
    masked_silicon = np.where(dilated > 0, 0.0, silicon_bin)
    carbon = compute_centroids(carbon_bin.astype(np.uint8), 1, 25, s)
    silicon = compute_centroids(masked_silicon.astype(np.uint8), 1, 140, s)
    positions = np.concatenate([np.asarray(carbon).reshape(-1, 2),
                                np.asarray(silicon).reshape(-1, 2)], axis=0)
    numbers = np.concatenate([np.full(len(carbon), constants.CARBON),
                              np.full(len(silicon), constants.SILICON)])
    return md.AtomicGrid(positions, numbers)
