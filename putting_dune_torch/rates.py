"""Transition-rate functions for the silicon dopant, batched.

Port of putting_dune_tpu/rates.py. Every function maps

    (si_pos (B, 2), neighbor_pos (B, 3, 2), beam_pos (B, 2)) -> rates (B, 3)

in the material frame (angstroms). The Gaussian-mixture and learned rate
families are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from putting_dune_torch import constants

RateFunction = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]


def simple_canonical_rates(
    si_pos: torch.Tensor,
    neighbor_pos: torch.Tensor,
    beam_pos: torch.Tensor,
) -> torch.Tensor:
  """Inverse-square beam falloff: 1 / ((4 d_i / bond)^2 + 1)."""
  del si_pos
  delta = beam_pos[..., None, :] - neighbor_pos
  dist = torch.linalg.vector_norm(delta, dim=-1)
  dist = dist / constants.CARBON_BOND_DISTANCE_ANGSTROMS
  return 1.0 / (torch.square(dist * 4.0) + 1.0)


def _gaussian2_exponent(diff: torch.Tensor, cov: np.ndarray) -> torch.Tensor:
  """-0.5 * diff^T cov^{-1} diff for a 2x2 covariance, closed form."""
  cov = np.asarray(cov, np.float32)
  a, b = cov[0, 0], cov[0, 1]
  c, d = cov[1, 0], cov[1, 1]
  det = np.float32(a * d - b * c)
  dx = diff[..., 0]
  dy = diff[..., 1]
  quad = (
      float(d) * dx * dx - float(b + c) * dx * dy + float(a) * dy * dy
  ) / float(det)
  return -0.5 * quad


def prior_rates(si_pos, neighbor_pos, beam_pos) -> torch.Tensor:
  """Human-designed Gaussian prior rates, bug-for-bug with the JAX package.

  Like the JAX package (and the upstream reference it copies), the prior
  MEAN is rotated by -angle_i, which puts the peak at the reflection of
  neighbor i whenever the neighbor is off the x-axis. The JAX package's
  aligned variant and its mean/cov/max_rate overrides are not ported.
  """
  rel_neighbors = neighbor_pos - si_pos[..., None, :]
  rel_beam = (beam_pos - si_pos) / constants.CARBON_BOND_DISTANCE_ANGSTROMS

  # cos/sin of each neighbor's angle without atan2: dx/r and dy/r.
  nx, ny = rel_neighbors[..., 0], rel_neighbors[..., 1]
  inv_r = torch.rsqrt(nx * nx + ny * ny)
  c = nx * inv_r
  s = ny * inv_r

  m0, m1 = (float(m) for m in constants.SIGR_PRIOR_RATE_MEAN)
  rotated_mean = torch.stack([m0 * c + m1 * s, -m0 * s + m1 * c], dim=-1)
  diff = rel_beam[..., None, :] - rotated_mean
  exponent = _gaussian2_exponent(diff, constants.SIGR_PRIOR_RATE_COV)
  return constants.SIGR_PRIOR_MAX_RATE * torch.exp(exponent)
