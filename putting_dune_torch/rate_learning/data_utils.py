"""Dataset generation, augmentation and canonicalization for rate learning.

Port of putting_dune_tpu/rate_learning/data_utils.py:

  * 6-fold symmetry augmentation: an optional reflection across y = 0,
    then all 3 lattice rotations (tensors);
  * synthetic data from the physical prior or a random network, drawn
    from a `torch.Generator` on its device;
  * bootstrap and fractional splits (numpy `default_rng`, so the same seed
    gives the JAX package's index sets);
  * canonical-frame standardization: rotate so the neighbor nearest the
    beam lies on +x, on the host (numpy) and batched on tensors for the
    learned rate function inside the planners.
"""

from __future__ import annotations

import enum
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import geometry


class SyntheticDataType(str, enum.Enum):
  NETWORK = 'network'
  PRIOR = 'prior'


# --- symmetry augmentation ---------------------------------------------------


def rotate_positions_all(position: torch.Tensor, num_states: int = 3):
  """The position rotated by 2 pi k / num_states, k = 0..n-1, stacked."""
  return torch.stack([
      geometry.rotate_coordinates(
          position, torch.tensor(2.0 * math.pi * k / num_states,
                                 device=position.device))
      for k in range(num_states)])


def reflect_transitions(next_state, dt, rates, position, context=None):
  """Reflects transitions across y = 0: neighbor 0 (on +x) stays, 1 and 2
  swap; state 0 (no transition) is kept."""
  swap = torch.tensor([0, 2, 1], device=next_state.device)
  ref_rates = rates[..., swap]
  ref_position = position * torch.tensor([1.0, -1.0], device=position.device)
  ref_state = swap[torch.clamp(next_state.long() - 1, min=0)] + 1
  ref_state = torch.where(next_state > 0, ref_state,
                          torch.zeros_like(ref_state)).to(next_state.dtype)
  return ref_state, dt, ref_rates, ref_position, context


def rotate_dataset(next_state, dt, rates, position, context=None,
                   num_states: int = 3):
  """All lattice rotations of a dataset, concatenated: rotation k advances
  the neighbor labels by k (mod 3), rolls the rates and rotates the
  positions by 2 pi k / 3."""
  states, dts, rolled, positions, contexts = [], [], [], [], []
  for k in range(num_states):
    states.append(torch.where(
        next_state > 0, (next_state - 1 + k) % num_states + 1,
        torch.zeros_like(next_state)))
    dts.append(dt)
    rolled.append(torch.roll(rates, k, dims=-1))
    positions.append(geometry.rotate_coordinates(
        position, torch.tensor(2.0 * math.pi * k / num_states,
                               device=position.device)))
    if context is not None:
      contexts.append(context)
  return (torch.cat(states), torch.cat(dts), torch.cat(rolled),
          torch.cat(positions),
          torch.cat(contexts) if context is not None else None)


def augment_data(next_state, dt, rates, position, context=None,
                 reflect: bool = True, num_states: int = 3
                 ) -> Mapping[str, torch.Tensor]:
  """Adds all valid reflections and rotations (6x with the reflection)."""
  if reflect:
    r_state, r_dt, r_rates, r_pos, r_ctx = reflect_transitions(
        next_state, dt, rates, position, context)
    next_state = torch.cat([next_state, r_state])
    dt = torch.cat([dt, r_dt])
    rates = torch.cat([rates, r_rates])
    position = torch.cat([position, r_pos])
    if context is not None:
      context = torch.cat([context, r_ctx])
  next_state, dt, rates, position, context = rotate_dataset(
      next_state, dt, rates, position, context, num_states=num_states)
  return {'next_state': next_state, 'dt': dt, 'rates': rates,
          'position': position, 'context': context}


# --- synthetic data ----------------------------------------------------------


def prior_rates_canonical(position: torch.Tensor) -> torch.Tensor:
  """Prior rates in a canonical 3-neighbor frame: the prior Gaussian at the
  position rotated by 2 pi k / 3, peak SIGR_PRIOR_MAX_RATE. position:
  (..., 2) beam in bond units; returns (..., 3)."""
  mean = torch.as_tensor(constants.SIGR_PRIOR_RATE_MEAN,
                         device=position.device)
  var = float(constants.SIGR_PRIOR_RATE_COV[0, 0])
  rot = rotate_positions_all(position)  # (3, ..., 2)
  d2 = torch.sum(torch.square(rot - mean), dim=-1)
  rates = constants.SIGR_PRIOR_MAX_RATE * torch.exp(-0.5 * d2 / var)
  return torch.movedim(rates, 0, -1)


def generate_synthetic_data(
    num_data: int = 100,
    generator: Optional[torch.Generator] = None,
    num_states: int = 3,
    position_dim: int = 2,
    context_dim: int = 2,
    actual_time_range: Tuple[float, float] = (0.0, 5.0),
    mode: SyntheticDataType = SyntheticDataType.PRIOR,
    device=None,
):
  """Synthetic transition datasets, drawn on `device` from `generator`.

  Each record: context (noise dims), position (beam), true rates, an
  exposure window dt ~ U(time_range) and next_state in {0 = none, 1..3 =
  neighbor} sampled from the rate law. Returns (train, test) dicts of
  tensors of num_data records each. The law is the JAX package's; the
  stream is the generator's (threefry and Philox differ).
  """
  from putting_dune_torch import device as device_lib

  device = device_lib.resolve_device(device)
  if generator is None:
    generator = torch.Generator(device=device).manual_seed(0)
  net = None
  if mode == SyntheticDataType.NETWORK:
    from putting_dune_torch.rate_learning import model as model_lib

    net = model_lib.RateMLP(1, context_dim + position_dim, (1, 64),
                            num_states, batchnorm=False, device=device,
                            generator=generator)

  def normal(*shape):
    return torch.randn(shape, generator=generator, device=device)

  def uniform(*shape):
    return torch.rand(shape, generator=generator, device=device)

  def sample_dataset():
    n = num_data
    if mode == SyntheticDataType.PRIOR:
      chol = torch.as_tensor(np.linalg.cholesky(
          np.asarray(constants.SIGR_PRIOR_RATE_COV, np.float64) * 1.5
      ).astype(np.float32), device=device)
      mean = torch.as_tensor(constants.SIGR_PRIOR_RATE_MEAN, device=device)
      position = mean + normal(n, position_dim) @ chol.T
      context = normal(n, context_dim)
      rates = prior_rates_canonical(position)
      # A random lattice rotation for coverage.
      rot_k = torch.randint(0, num_states, (n,), generator=generator,
                            device=device)
      position = geometry.rotate_coordinates(
          position, 2.0 * math.pi * rot_k.float() / num_states)
      cols = (torch.arange(num_states, device=device) - rot_k[:, None]
              ) % num_states
      rates_rolled = torch.gather(rates, 1, cols)
      rates_for_choice = rates
    else:
      full = normal(n, context_dim + position_dim)
      context, position = full[:, :context_dim], full[:, context_dim:]
      with torch.no_grad():
        rates_for_choice = net(full)[0, :, :-1]
      rates_rolled = rates_for_choice
      rot_k = torch.zeros((n,), dtype=torch.long, device=device)
    total = rates_for_choice.sum(-1)
    raw_state = torch.multinomial(rates_for_choice / total[:, None], 1,
                                  generator=generator)[:, 0]
    raw_state = (raw_state + rot_k) % num_states
    next_time = -torch.log1p(-uniform(n)) / total
    lo, hi = actual_time_range
    dt = lo + (hi - lo) * uniform(n)
    next_state = torch.where(next_time < dt, raw_state + 1,
                             torch.zeros_like(raw_state))
    return {'next_state': next_state.to(torch.int32), 'dt': dt,
            'rates': rates_rolled, 'context': context, 'position': position}

  return sample_dataset(), sample_dataset()


# --- splits ------------------------------------------------------------------


def bootstrap_dataset(data: Mapping[str, np.ndarray], seed: int):
  """Bootstrap resample; the test set is the out-of-bag samples."""
  rng = np.random.default_rng(seed)
  n = len(next(iter(data.values())))
  indices = rng.choice(n, size=n, replace=True)
  train = {k: np.asarray(a)[indices] for k, a in data.items()}
  oob = np.setdiff1d(np.arange(n), indices)
  test = {k: np.asarray(a)[oob] for k, a in data.items()}
  return train, test


def split_dataset(data: Mapping[str, np.ndarray], seed: int,
                  test_fraction: float = 0.1):
  """A random train/test split."""
  rng = np.random.default_rng(seed)
  n = len(next(iter(data.values())))
  perm = rng.permutation(n)
  cut = int(n * test_fraction)
  test_idx, train_idx = perm[:cut], perm[cut:]
  train = {k: np.asarray(a)[train_idx] for k, a in data.items()}
  test = {k: np.asarray(a)[test_idx] for k, a in data.items()}
  return train, test


# --- canonicalization --------------------------------------------------------


def standardize_beam_and_neighbors(beam_position: np.ndarray,
                                   neighbor_position: np.ndarray):
  """Rotates so the neighbor nearest the beam lies on +x (host, numpy).

  The beam is usually in bond units while the neighbors stay in
  angstroms; the nearest-neighbor choice uses those raw values, as the JAX
  package (and the reference) do. Returns (rotated beam, rotated
  neighbors, state_order): state_order maps canonical rank (CCW from +x)
  to the original neighbor index.
  """
  beam = np.asarray(beam_position).reshape(1, 2)
  nbrs = np.asarray(neighbor_position).reshape(-1, 2)
  nearest = np.argmin(np.linalg.norm(nbrs - beam, axis=1))
  angles = np.arctan2(nbrs[:, 1], nbrs[:, 0])
  rot = -angles[nearest]
  cos, sin = np.cos(rot), np.sin(rot)
  mat = np.array([[cos, sin], [-sin, cos]])
  new_nbrs = nbrs @ mat
  new_beam = beam @ mat
  positive = (angles + rot) % (2 * np.pi)
  state_order = np.argsort(positive)
  return new_beam, new_nbrs, state_order


def standardize_batched(beam_position: torch.Tensor,
                        neighbor_position: torch.Tensor):
  """Batched standardization for the learned rate function.

  beam_position (B, 2) relative to the silicon; neighbor_position (B, 3, 2)
  relative to the silicon (angstroms). Returns (rotated beam (B, 2),
  rotated neighbors (B, 3, 2), state_order (B, 3)). Ties go to the first
  neighbor in argmin and keep their order in the (stable) argsort, as in
  the JAX package.
  """
  d = torch.linalg.vector_norm(
      neighbor_position - beam_position[:, None, :], dim=-1)
  nearest = torch.argmin(d, dim=-1)
  angles = geometry.get_angles(neighbor_position)  # (B, 3)
  rot = -torch.gather(angles, 1, nearest[:, None])[:, 0]
  new_nbrs = geometry.rotate_coordinates(neighbor_position, rot[:, None])
  new_beam = geometry.rotate_coordinates(beam_position, rot)
  positive = torch.remainder(angles + rot[:, None], 2.0 * math.pi)
  state_order = torch.argsort(positive, dim=-1, stable=True)
  return new_beam, new_nbrs, state_order
