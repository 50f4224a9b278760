"""Static graphene lattice generation and neighbor topology.

Port of putting_dune_tpu/lattice.py. Transitions only relabel which site
carries the silicon, and episode randomization is a rigid transform, so
the lattice is built once on the host: canonical positions (N, 2) and a
static (N, 3) nearest-neighbor table. Per-environment state is just
(offset, theta, si_index); world positions are (canonical + offset)
rotated by theta.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import geometry


def hexagonal_grid_unit(num_cols: int = 50) -> np.ndarray:
  """Unit-spacing honeycomb, shape (num_atoms, 2) float64."""
  ratio = np.sqrt(3.0) / 2.0
  num_rows = int(num_cols / ratio)

  coord_x, coord_y = np.meshgrid(
      np.arange(num_cols), np.arange(num_rows), indexing='xy'
  )
  coord_y = coord_y * ratio
  coord_x = coord_x.astype(np.float64)
  coord_x[1::2, :] += 0.5

  keep = np.ones((num_rows, num_cols), dtype=bool)
  keep[0::2, 0::3] = False
  keep[1::2, 1::3] = False
  return np.stack((coord_x[keep], coord_y[keep]), axis=1)


def canonical_graphene_positions(num_cols: int = 50) -> np.ndarray:
  """Canonical centered graphene sheet in angstroms, (N, 2) float64."""
  positions = hexagonal_grid_unit(num_cols)
  positions = positions * constants.CARBON_BOND_DISTANCE_ANGSTROMS
  return positions - positions.mean(axis=0, keepdims=True)


def canonical_graphene_with_centered_silicon(
    num_cols: int = 10,
) -> tuple[np.ndarray, np.ndarray]:
  """The canonical sheet shifted so that its silicon site (the site
  nearest the centroid) sits at (0, 0): (positions (N, 2) float64,
  atomic_numbers (N,) int32)."""
  positions = canonical_graphene_positions(num_cols)
  atomic_numbers = np.full(positions.shape[0], constants.CARBON, np.int32)
  si_idx = int(np.argmin(np.sum(positions**2, axis=1)))
  atomic_numbers[si_idx] = constants.SILICON
  return positions - positions[si_idx:si_idx + 1], atomic_numbers


def build_neighbor_table(positions: np.ndarray, k: int = 3) -> np.ndarray:
  """Static (N, k) int table of each atom's k nearest neighbors.

  Exact numpy distances; ties broken by index order (stable sort).
  """
  n = positions.shape[0]
  table = np.empty((n, k), dtype=np.int64)
  chunk = 512
  for start in range(0, n, chunk):
    stop = min(start + chunk, n)
    d2 = np.sum(
        (positions[start:stop, None, :] - positions[None, :, :]) ** 2, axis=-1
    )
    d2[np.arange(stop - start), np.arange(start, stop)] = np.inf
    table[start:stop] = np.argsort(d2, axis=1, kind='stable')[:, :k]
  return table


@dataclasses.dataclass(frozen=True, eq=False)
class Lattice:
  """Device-resident static lattice shared by every environment.

  Attributes:
    positions: (N, 2) float32 canonical centered positions, angstroms.
    neighbors: (N, 3) int64 static nearest-neighbor table.
  """

  positions: torch.Tensor
  neighbors: torch.Tensor

  @property
  def num_atoms(self) -> int:
    return self.positions.shape[0]

  @property
  def device(self) -> torch.device:
    return self.positions.device


@functools.lru_cache(maxsize=8)
def _build_lattice_host(num_cols: int) -> tuple[np.ndarray, np.ndarray]:
  positions = canonical_graphene_positions(num_cols)
  neighbors = build_neighbor_table(positions)
  return positions.astype(np.float32), neighbors


def make_lattice(num_cols: int = 50, device='cpu') -> Lattice:
  """Builds (and caches on the host) the lattice, placed on `device`."""
  positions, neighbors = _build_lattice_host(num_cols)
  return Lattice(
      positions=torch.from_numpy(positions).to(device),
      neighbors=torch.from_numpy(neighbors).to(device),
  )


def world_positions(
    lattice: Lattice, offset: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
  """All atom positions in the material frame: offset (..., 2), theta
  (...,) -> (..., N, 2). Center, add offset, then rotate."""
  shifted = lattice.positions + offset[..., None, :]
  return geometry.rotate_coordinates(shifted, theta[..., None])


def site_position(
    lattice: Lattice,
    site_index: torch.Tensor,
    offset: torch.Tensor,
    theta: torch.Tensor,
) -> torch.Tensor:
  """World position of specific site(s), O(1) per site.

  site_index: (...,) or (..., K); offset (..., 2); theta (...,). Returns
  site_index.shape + (2,).
  """
  canon = lattice.positions[site_index]
  extra_dims = site_index.dim() - theta.dim()
  th = theta.reshape(theta.shape + (1,) * extra_dims)
  off = offset.reshape(offset.shape[:-1] + (1,) * extra_dims + (2,))
  return geometry.rotate_coordinates(canon + off, th)


def initial_silicon_index(
    lattice: Lattice, offset: torch.Tensor
) -> torch.Tensor:
  """Index of the site nearest the origin after the offset shift, (...,)."""
  shifted = lattice.positions + offset[..., None, :]
  d2 = torch.sum(shifted * shifted, dim=-1)
  return torch.argmin(d2, dim=-1)
