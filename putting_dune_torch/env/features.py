"""Feature constructors: observation -> agent features, batched.

Port of the image and the two 10-dim vector features of
putting_dune_tpu/env/features.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from putting_dune_torch import geometry
from putting_dune_torch import structures
from putting_dune_torch.env import goals as goals_lib
from putting_dune_torch.imaging import render as render_lib


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
  """Shape and dtype of one observation array (without the batch dim)."""

  shape: tuple[int, ...]
  dtype: type = np.float32


def _goal_delta_angstroms(obs: structures.MicroscopeObservation,
                          goal: goals_lib.GoalState) -> torch.Tensor:
  """Goal minus silicon, material frame."""
  si_material = obs.fov.microscope_to_material(obs.si_position_microscope)
  return goal.position_material - si_material


@dataclasses.dataclass(frozen=True)
class SingleSiliconPristineGrapheneFeatures:
  """[si_xy (microscope), 3 normalized neighbor deltas (microscope), goal
  delta (angstroms)], (B, 10)."""

  requires_image: bool = False
  requires_window: bool = False

  def spec(self) -> FeatureSpec:
    return FeatureSpec((10,))

  def __call__(self, obs, goal) -> torch.Tensor:
    deltas = (obs.neighbor_positions_microscope
              - obs.si_position_microscope[..., None, :])
    norms = torch.linalg.vector_norm(deltas, dim=-1, keepdim=True)
    normalized = deltas / torch.clamp(norms, min=1e-12)
    batch = obs.si_position_microscope.shape[0]
    return torch.cat(
        [obs.si_position_microscope, normalized.reshape(batch, 6),
         _goal_delta_angstroms(obs, goal)],
        dim=-1,
    ).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class SingleSiliconMaterialFrameFeatures:
  """[si_xy (angstroms), 3 raw neighbor deltas (angstroms), goal delta
  (angstroms)], (B, 10)."""

  requires_image: bool = False
  requires_window: bool = False

  def spec(self) -> FeatureSpec:
    return FeatureSpec((10,))

  def __call__(self, obs, goal) -> torch.Tensor:
    si_material = obs.fov.microscope_to_material(obs.si_position_microscope)
    nbr_material = geometry.microscope_to_material(
        obs.neighbor_positions_microscope,
        obs.fov.lower_left[..., None, :],
        obs.fov.upper_right[..., None, :],
    )
    deltas = nbr_material - si_material[..., None, :]
    goal_delta = goal.position_material - si_material
    batch = si_material.shape[0]
    return torch.cat(
        [si_material, deltas.reshape(batch, 6), goal_delta], dim=-1
    ).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ImageFeatures:
  """{'image': (B, S, S, 1), 'goal_delta_angstroms': (B, 2)} features.

  include_fov adds the instrument's believed field of view,
  'fov_lower_left' and 'fov_upper_right' (B, 2), material-frame angstroms:
  in-loop drift correctors need it to tell commanded FOV motion from drift.
  """

  image_size: int = 128
  include_fov: bool = False
  requires_image: bool = True
  requires_window: bool = False

  def spec(self) -> Dict[str, FeatureSpec]:
    spec = {
        'image': FeatureSpec((self.image_size, self.image_size, 1)),
        'goal_delta_angstroms': FeatureSpec((2,)),
    }
    if self.include_fov:
      spec['fov_lower_left'] = FeatureSpec((2,))
      spec['fov_upper_right'] = FeatureSpec((2,))
    return spec

  def __call__(self, obs, goal) -> Dict[str, torch.Tensor]:
    if obs.image is None:
      raise ValueError('ImageFeatures requires an observation with an image.')
    image = obs.image
    if image.shape[-1] != self.image_size:
      image = render_lib.resize_bilinear(image, self.image_size)
    features = {
        'image': image[..., None].to(torch.float32),
        'goal_delta_angstroms': _goal_delta_angstroms(obs, goal).to(
            torch.float32),
    }
    if self.include_fov:
      features['fov_lower_left'] = obs.fov.lower_left.to(torch.float32)
      features['fov_upper_right'] = obs.fov.upper_right.to(torch.float32)
    return features
