"""ImageAligner: learned drift correction + atom detection at inference.

Port of putting_dune_tpu/image_alignment/inference.py. A rolling history
of frames and their claimed fields of view; each new frame is equalised
(CLAHE through `equalize_adapthist_padded`, on the device: `clahe_small`
for a 128^2 frame, `clahe_hist_lut` + `clahe_remap` for larger ones),
resized to the model's size (nearest), min-max normalised, stacked with
the history frames re-cropped to its FOV, and run through the
GlobalLocalUNet (full float32 convolutions; softmax on the device). The
host then turns the queried frame's class probabilities into atom
centroids (imaging/morphology.py) and, with `hybrid`, refines the
predicted drift by ICP (alignment/classical.py).

The local head's 3 T channels are frame-major in NHWC, as are the global
head's 2 T drifts: logits reshape to (S, S, T, 3), drifts to (T, 2).
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import microscope_data as md
from putting_dune_torch.agents import eval_agent
from putting_dune_torch.alignment import classical
from putting_dune_torch.image_alignment import model as model_lib
from putting_dune_torch.image_alignment import train as train_lib
from putting_dune_torch.imaging import clahe as clahe_lib
from putting_dune_torch.imaging import morphology

# The shipped aligner, read in place.
SHIPPED_ALIGNER_DIR = os.path.join(eval_agent.MODEL_WEIGHTS_DIR,
                                   'image_aligner')

# Marker files of the shipped aligner: trained on cumulative-drift labels,
# and on the registration protocol of inference.
LABELS_CUMULATIVE = 'LABELS_CUMULATIVE'
REGISTRATION_TRAINED = 'REGISTRATION_TRAINED'


def has_marker(workdir: str, marker: str) -> bool:
  return os.path.exists(os.path.join(workdir, marker))


class ImageAligner:
  """Applies a trained GlobalLocalUNet over a rolling frame history.

  device: CUDA unless asked otherwise (device.resolve_device). seed: the
  hybrid ICP's generator (fresh entropy if None).
  """

  def __init__(
      self,
      params,
      *,
      features: Tuple[int, ...] = (32, 64, 128, 256),
      history_length: int = 5,
      image_size: int = 128,
      hybrid: bool = False,
      adaptive_normalization: bool = True,
      device=None,
      seed: Optional[int] = None,
  ):
    self.device = device_lib.resolve_device(device)
    module = model_lib.GlobalLocalUNet(
        local_output_size=3 * history_length,
        global_output_size=2 * history_length,
        features=features,
        in_channels=history_length,
    )
    module.load_state_dict(model_lib.params_from_flax(params))
    self.module = module.to(self.device).eval()
    self.history_length = history_length
    self.image_size = image_size
    self.hybrid = hybrid
    self.adaptive_normalization = adaptive_normalization
    self.needs_reset = True
    self.postprocessing_aligner = None
    if hybrid:
      self.postprocessing_aligner = classical.IterativeAlignmentFiltering(
          history_length=1,
          alignment_iterations=1,
          noise_scale=0.0,
          max_shift=constants.CARBON_BOND_DISTANCE_ANGSTROMS / 2,
          merge_cutoff=constants.CARBON_BOND_DISTANCE_ANGSTROMS / 2,
          accumulate_merged=False,
          clique_merging=True,
          trim=0.5,
          seed=seed,
      )

  @classmethod
  def from_checkpoint(
      cls, workdir: str = SHIPPED_ALIGNER_DIR, *,
      features: Tuple[int, ...] = (32, 64, 128, 256),
      history_length: int = 5, image_size: int = 128, **kwargs,
  ) -> 'ImageAligner':
    """Loads `workdir`/params.msgpack; its arch.json, where present, sets
    the feature pyramid and the frame count."""
    arch = train_lib.load_arch(workdir)
    if arch is not None:
      features = tuple(arch['features'])
      history_length = int(arch.get('num_frames', history_length))
    return cls(train_lib.load_params(workdir), features=features,
               history_length=history_length, image_size=image_size,
               **kwargs)

  def reset(self, example_image: Optional[np.ndarray] = None) -> None:
    """Clears the frame and FOV history. The next frame re-seeds the whole
    history with itself at its own claim, so that the stack is a valid
    zero-drift anchor from the first step (drift predictions are anchored
    on the history's claims)."""
    s = self.image_size
    dummy = (np.zeros((s, s, 1), np.float32) if example_image is None
             else np.zeros_like(example_image))
    self.image_history = collections.deque(maxlen=self.history_length - 1)
    self.fov_history = collections.deque(maxlen=self.history_length - 1)
    for _ in range(self.history_length - 1):
      self.image_history.append(dummy)
      self.fov_history.append(
          md.MicroscopeFieldOfView(np.zeros(2), np.full(2, 20.0)))
    if self.hybrid:
      self.postprocessing_aligner.reset()
    self.needs_reset = False
    self._seed_pending = True

  # -- detection helpers ------------------------------------------------------

  @classmethod
  def compute_centroids(cls, classes: np.ndarray, class_index: int,
                        erode_iters: int = 1):
    """Centroids (x, y) of one class in an argmax map, microscope frame
    (origin at the bottom left)."""
    mask = np.where(classes == class_index, 255, 0).astype(np.uint8)
    if erode_iters:
      mask = morphology.erode(mask, erode_iters)
    return [(c_x / classes.shape[1], 1.0 - c_y / classes.shape[0])
            for c_x, c_y in morphology.contour_centroids(mask)]

  @classmethod
  def process_detection_predictions(
      cls, probs: np.ndarray, buffer_width: float = 0.05) -> md.AtomicGrid:
    """Per-pixel probabilities (S, S, 3) -> microscope-frame AtomicGrid."""
    classes = np.argmax(probs, axis=-1)
    carbon = np.asarray(
        cls.compute_centroids(classes, 1, erode_iters=1)).reshape(-1, 2)
    silicon = np.asarray(
        cls.compute_centroids(classes, 2, erode_iters=3)).reshape(-1, 2)
    positions = np.concatenate([carbon, silicon], axis=0)
    numbers = np.concatenate([
        np.full(len(carbon), constants.CARBON),
        np.full(len(silicon), constants.SILICON),
    ]).astype(np.int32)
    in_bounds = ((positions > buffer_width).all(-1)
                 & (positions < 1 - buffer_width).all(-1))
    return md.AtomicGrid(positions[in_bounds], numbers[in_bounds])

  def refine_history_claims(self, step_size: float = 1.0) -> None:
    """Re-corrects the FOV claims of the frames still in the history from
    the last stack's per-frame drift heads: head i maps to pre-append
    history entry i, so after the append surviving entry j takes head
    j + 1 (the newest claim is the caller's, through amend_last_fov)."""
    if not hasattr(self, 'last_drifts'):
      return
    for j in range(len(self.fov_history) - 1):
      self.fov_history[j] = self.fov_history[j].shift(
          self.last_drifts[j + 1] * step_size)

  def amend_last_fov(self, fov: md.MicroscopeFieldOfView) -> None:
    """Replaces the FOV recorded for the newest frame (a caller's corrected
    claim), so that the next stack is anchored on a registered history."""
    if self.fov_history:
      self.fov_history[-1] = fov

  # -- the main entry point ---------------------------------------------------

  def preprocess(self, image: np.ndarray) -> np.ndarray:
    """One frame (H, W[, 1]) of any size -> (S, S, 1) in [0, 1]: CLAHE on
    the device, nearest resize, min-max normalisation."""
    s = self.image_size
    image = np.asarray(image, np.float32)
    if image.ndim == 3:
      image = image[..., 0]
    if self.adaptive_normalization:
      frame = torch.tensor(image, device=self.device)[None]
      image = clahe_lib.equalize_adapthist_padded(frame)[0].cpu().numpy()
    image = morphology.resize_nearest(image, s, s)[..., None]
    lo, hi = image.min(), image.max()
    return (image - lo) / max(hi - lo, 1e-12)

  def forward(self, framestack: np.ndarray
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, S, T) stack -> (logits (S, S, T, 3), drifts (T, 2)) on the
    device, full float32 convolutions."""
    s = self.image_size
    x = torch.as_tensor(framestack, device=self.device)[None]
    with torch.no_grad(), torch.backends.cudnn.flags(
        enabled=True, benchmark=False, allow_tf32=False):
      logits, drift = self.module(x)
    return (logits[0].reshape(s, s, self.history_length, 3),
            drift[0].reshape(self.history_length, 2))

  def __call__(
      self,
      image: np.ndarray,
      fov: md.MicroscopeFieldOfView,
      grid: Optional[md.AtomicGrid] = None,
      time_index: int = -1,
  ) -> Tuple[md.AtomicGrid, np.ndarray, np.ndarray]:
    """Aligns and detects one new frame.

    Returns (the grid in the microscope frame, the predicted drift (2,) in
    angstroms, the queried frame's per-pixel class probabilities).
    """
    image = self.preprocess(image)
    if self.needs_reset:
      self.reset(example_image=image)
    if self._seed_pending:
      for _ in range(self.history_length - 1):
        self.image_history.append(image.copy())
        self.fov_history.append(fov)
      self._seed_pending = False

    padded = [
        classical.pad_and_crop_images_by_fov(old_img, old_fov, fov)
        for old_img, old_fov in zip(self.image_history, self.fov_history)
    ]
    padded.append(image)
    framestack = np.concatenate(padded, axis=-1).astype(np.float32)

    logits, drifts = self.forward(framestack)
    probs = torch.softmax(logits[..., time_index, :], dim=-1).cpu().numpy()
    # Every per-frame drift head of this stack, for refine_history_claims.
    self.last_drifts = drifts.cpu().numpy()
    pred_drift = self.last_drifts[time_index]

    if grid is None:
      grid = self.process_detection_predictions(probs)

    self.image_history.append(image)
    self.fov_history.append(fov)

    if self.hybrid:
      try:
        shifted_fov = fov.shift(-pred_drift)
        material_grid = shifted_fov.microscope_frame_to_material_frame(grid)
        postprocessed, post_drift = self.postprocessing_aligner(
            material_grid)
        pred_drift = pred_drift + post_drift
        shifted_fov = fov.shift(-pred_drift)
        grid = shifted_fov.material_frame_to_microscope_frame(postprocessed)
      except Exception:  # pylint: disable=broad-except
        # The loop keeps running on the network's drift alone, as in the
        # JAX package; the ICP history starts again.
        logging.exception('ImageAligner: hybrid postprocessing failed')
        self.postprocessing_aligner.reset()

    return grid, pred_drift, probs
