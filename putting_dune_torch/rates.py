"""Transition-rate functions for the silicon dopant, batched.

Port of putting_dune_tpu/rates.py. Every function maps

    (si_pos (B, 2), neighbor_pos (B, 3, 2), beam_pos (B, 2)) -> rates (B, 3)

in the material frame (angstroms). The learned neural rate family is
`rate_learning.LearnedRatePredictor.as_rate_function()`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Protocol

import numpy as np
import torch

from putting_dune_torch import constants

RateFunction = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]


class RateFunctionProtocol(Protocol):
  """A rate law: (si_pos, neighbor_pos, beam_pos) -> rates."""

  def __call__(self, si_pos: torch.Tensor, neighbor_pos: torch.Tensor,
               beam_pos: torch.Tensor) -> torch.Tensor:
    ...


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


def prior_rates(si_pos, neighbor_pos, beam_pos, *, mean=None, cov=None,
                max_rate=None) -> torch.Tensor:
  """Human-designed Gaussian prior rates, bug-for-bug with the JAX package.

  For each neighbor, a Gaussian (cov 0.1 I in bond units) peaking at
  max_rate = ln(2)/3. Like the JAX package (and the upstream reference it
  copies), the prior MEAN is rotated by -angle_i, which puts the peak at the
  reflection of neighbor i whenever the neighbor is off the x-axis;
  `prior_rates_aligned` is the physically intended law.
  """
  return _prior_rates_impl(si_pos, neighbor_pos, beam_pos, mean=mean,
                           cov=cov, max_rate=max_rate, aligned=False)


def prior_rates_aligned(si_pos, neighbor_pos, beam_pos, *, mean=None,
                        cov=None, max_rate=None) -> torch.Tensor:
  """Gaussian prior rates peaking 0.85 bonds toward each neighbor: the beam
  is rotated into each neighbor's canonical frame instead of the mean."""
  return _prior_rates_impl(si_pos, neighbor_pos, beam_pos, mean=mean,
                           cov=cov, max_rate=max_rate, aligned=True)


def _prior_rates_impl(si_pos, neighbor_pos, beam_pos, *, mean, cov, max_rate,
                      aligned: bool) -> torch.Tensor:
  mean = constants.SIGR_PRIOR_RATE_MEAN if mean is None else mean
  cov = constants.SIGR_PRIOR_RATE_COV if cov is None else cov
  max_rate = constants.SIGR_PRIOR_MAX_RATE if max_rate is None else max_rate

  rel_neighbors = neighbor_pos - si_pos[..., None, :]
  rel_beam = (beam_pos - si_pos) / constants.CARBON_BOND_DISTANCE_ANGSTROMS

  # cos/sin of each neighbor's angle without atan2: dx/r and dy/r.
  nx, ny = rel_neighbors[..., 0], rel_neighbors[..., 1]
  inv_r = torch.rsqrt(nx * nx + ny * ny)
  c = nx * inv_r
  s = ny * inv_r

  m0, m1 = (float(m) for m in np.asarray(mean, np.float32))
  if aligned:
    bx = rel_beam[..., None, 0]
    by = rel_beam[..., None, 1]
    diff = torch.stack([bx * c + by * s - m0, -bx * s + by * c - m1], dim=-1)
  else:
    rotated_mean = torch.stack([m0 * c + m1 * s, -m0 * s + m1 * c], dim=-1)
    diff = rel_beam[..., None, :] - rotated_mean
  return float(max_rate) * torch.exp(_gaussian2_exponent(diff, cov))


@dataclasses.dataclass(frozen=True)
class GaussianMixtureRateFunction:
  """Mixture-of-Gaussians rate family (port of the JAX package's class).

  Each component places a Gaussian at `si + delta_i * loc_distance` along
  the silicon->neighbor vector, with covariance axes along and across that
  vector (variances[:, 0], variances[:, 1]). Densities are evaluated at the
  absolute beam position and scaled so the largest component peak equals
  max_rate. Parameters are host numpy; `__call__` works on tensors.
  """

  max_rate: float
  mixture_weights: np.ndarray  # (M,)
  loc_distances: np.ndarray  # (M,)
  variances: np.ndarray  # (M, 2)

  @property
  def normalizing_factor(self) -> float:
    """max_rate / max_m (w_m * peak density of component m)."""
    det = self.variances[:, 0] * self.variances[:, 1]
    mode_prob = 1.0 / (2.0 * np.pi * np.sqrt(det))
    return float(self.max_rate / np.max(mode_prob * self.mixture_weights))

  def __call__(self, si_pos, neighbor_pos, beam_pos) -> torch.Tensor:
    device = si_pos.device
    delta = neighbor_pos - si_pos[..., None, :]  # (B, 3, 2)
    e1 = delta / torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    e2 = torch.stack([-e1[..., 1], e1[..., 0]], dim=-1)

    def tensor(x):
      return torch.as_tensor(np.asarray(x, np.float32), device=device)

    loc_d, weights, variances = (tensor(self.loc_distances),
                                 tensor(self.mixture_weights),
                                 tensor(self.variances))
    # (B, 3, M, 2): beam minus each component's centre.
    loc = si_pos[..., None, None, :] + delta[..., None, :] * loc_d[:, None]
    diff = beam_pos[..., None, None, :] - loc
    # The covariance eigenbasis is orthonormal, so the quadratic form is
    # (diff.e1)^2 / v1 + (diff.e2)^2 / v2 and det = v1 v2.
    p1 = torch.sum(diff * e1[..., None, :], dim=-1)  # (B, 3, M)
    p2 = torch.sum(diff * e2[..., None, :], dim=-1)
    v1, v2 = variances[:, 0], variances[:, 1]
    quad = p1 * p1 / v1 + p2 * p2 / v2
    density = torch.exp(-0.5 * quad) / (2.0 * np.pi * torch.sqrt(v1 * v2))
    return torch.sum(density * weights * self.normalizing_factor, dim=-1)

  # -- (de)serialization: the same `gmm_parameters.mpk` bundle keys and
  # msgpack-numpy array layout as the JAX package, so bundles cross.

  def serialize_to_directory(self, save_dir) -> None:
    from putting_dune_torch.io import serialization

    os.makedirs(save_dir, exist_ok=True)
    bundle = {
        'sem_ver': '1.0.0',
        'max_rate': float(self.max_rate),
        'mixture_weights': np.asarray(self.mixture_weights),
        'loc_distances': np.asarray(self.loc_distances),
        'variances': np.asarray(self.variances),
    }
    with open(os.path.join(save_dir, 'gmm_parameters.mpk'), 'wb') as f:
      f.write(serialization.packb(bundle,
                                  default=serialization.msgpack_encode))

  @classmethod
  def deserialize_from_directory(cls, load_dir
                                 ) -> 'GaussianMixtureRateFunction':
    from putting_dune_torch.io import serialization

    with open(os.path.join(load_dir, 'gmm_parameters.mpk'), 'rb') as f:
      bundle = serialization.msgpack_decode_tree(
          serialization.unpackb(f.read()))
    return cls(
        max_rate=bundle['max_rate'],
        mixture_weights=np.asarray(bundle['mixture_weights']),
        loc_distances=np.asarray(bundle['loc_distances']),
        variances=np.asarray(bundle['variances']),
    )

  @classmethod
  def sample_new(cls, rng: np.random.Generator
                 ) -> 'GaussianMixtureRateFunction':
    """A random GMM for domain randomization; the same draws from `rng` as
    the JAX package's."""
    num_mixtures = rng.poisson(2.0) + 1
    max_rate = rng.uniform(0.01, 1.0)
    mixture_weights = rng.uniform(0.0, 10.0, size=(num_mixtures,))
    mixture_weights = mixture_weights / np.sum(mixture_weights)
    loc_distances = rng.uniform(-2.0, 3.0, size=(num_mixtures,))
    variances = rng.uniform(0.1, 5.0, size=(num_mixtures, 2))
    return cls(max_rate=max_rate, mixture_weights=mixture_weights,
               loc_distances=loc_distances, variances=variances)

  def __eq__(self, other) -> bool:
    if not isinstance(other, GaussianMixtureRateFunction):
      return NotImplemented
    if (self.mixture_weights.shape != other.mixture_weights.shape
        or self.loc_distances.shape != other.loc_distances.shape
        or self.variances.shape != other.variances.shape):
      return False
    return (
        abs(self.max_rate - other.max_rate) <= 1e-3
        and (np.abs(self.mixture_weights - other.mixture_weights)
             <= 1e-3).all()
        and (np.abs(self.loc_distances - other.loc_distances) <= 1e-3).all()
        and (np.abs(self.variances - other.variances) <= 1e-3).all()
    )

  def __hash__(self):
    return hash((round(float(self.max_rate), 3), self.mixture_weights.shape))
