"""2D geometry helpers on tensors (port of putting_dune_tpu/geometry.py).

Frame conventions are the JAX package's:

  * "material frame": absolute angstrom coordinates on the sheet.
  * "microscope frame": [0, 1]^2 normalized coordinates within the current
    field of view, (0, 0) = lower-left.
  * Angles CCW from +x; rotations are CCW.
"""

from __future__ import annotations

import torch


def get_angles(coordinates: torch.Tensor) -> torch.Tensor:
  """Angle of each (x, y) row CCW from the +x axis, in radians."""
  return torch.atan2(coordinates[..., 1], coordinates[..., 0])


def rotate_coordinates(
    coords: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
  """Rotates (..., 2) coordinates by theta radians counter-clockwise.

  theta broadcasts against coords[..., 0].
  """
  cos = torch.cos(theta)
  sin = torch.sin(theta)
  x = coords[..., 0]
  y = coords[..., 1]
  return torch.stack([x * cos - y * sin, x * sin + y * cos], dim=-1)


def microscope_to_material(
    point: torch.Tensor, lower_left: torch.Tensor, upper_right: torch.Tensor
) -> torch.Tensor:
  """Maps [0,1]^2 microscope coords to angstrom material coords."""
  scale = upper_right - lower_left
  return point * scale + lower_left


def material_to_microscope(
    point: torch.Tensor, lower_left: torch.Tensor, upper_right: torch.Tensor
) -> torch.Tensor:
  """Maps angstrom material coords to [0,1]^2 microscope coords."""
  scale = upper_right - lower_left
  return (point - lower_left) / scale
