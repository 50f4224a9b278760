"""2D geometry helpers on tensors (port of putting_dune_tpu/geometry.py).

Frame conventions are the JAX package's:

  * "material frame": absolute angstrom coordinates on the sheet.
  * "microscope frame": [0, 1]^2 normalized coordinates within the current
    field of view, (0, 0) = lower-left.
  * Angles CCW from +x; rotations are CCW.
"""

from __future__ import annotations

from typing import Optional

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


def nearest_neighbors(
    atom_positions: torch.Tensor,
    query: torch.Tensor,
    k: int,
    *,
    include_self: bool = False,
    valid_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The k nearest atoms to each query under L2: (distances, indices),
  each (Q, k), or (k,) for a single (2,) query.

  Without include_self the nearest point (the query itself when it is an
  atom) is dropped: k + 1 are fetched and the first is stripped. Rows
  where `valid_mask` (N,) is false are at distance inf. Among equal
  distances the lower index comes first, as jax.lax.top_k orders them.
  """
  single = query.dim() == 1
  q = query.reshape(-1, 2)
  deltas = q[:, None, :] - atom_positions[None, :, :]
  dist2 = torch.sum(deltas * deltas, dim=-1)
  if valid_mask is not None:
    dist2 = torch.where(valid_mask[None, :], dist2, float('inf'))
  fetch = k + (0 if include_self else 1)
  dist2, indices = torch.sort(dist2, dim=-1, stable=True)
  distances = torch.sqrt(torch.clamp(dist2[:, :fetch], min=0.0))
  indices = indices[:, :fetch]
  if not include_self:
    distances, indices = distances[:, 1:], indices[:, 1:]
  if single:
    return distances.reshape(-1), indices.reshape(-1)
  return distances, indices


def nearest_neighbors3(
    atom_positions: torch.Tensor,
    query: torch.Tensor,
    *,
    include_self: bool = False,
    valid_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
  """The 3 (4 with self) nearest neighbours of each query row."""
  return nearest_neighbors(atom_positions, query, 3,
                           include_self=include_self, valid_mask=valid_mask)


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
