"""Host-side microscope data structures (numpy dataclasses).

Port of putting_dune_tpu/microscope_data.py: atomic grids, beam controls,
fields of view with their frame conversions, observations, transitions,
trajectories, drift labels and labeled alignment trajectories, with the
same fields, equality and hashes.
This is the boundary between the batched device simulator (structures.py)
and the real-microscope loop and the offline pipelines; frames are by
convention ("microscope" = [0, 1]^2, "material" = angstroms).

The proto round trips (`to_proto`, `from_proto`, `*_proto_bytes`) and the
image wire format are not ported: they need the protobuf wire codec.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import spatial

from putting_dune_torch import constants


@dataclasses.dataclass(frozen=True)
class AtomicGrid:
  """Atom positions (N, 2) + atomic numbers (N,).

  Two grids are equal when each atom has a distinct nearest atom of the
  same species in the other, closer than 1e-6.
  """

  atom_positions: np.ndarray
  atomic_numbers: np.ndarray

  def __post_init__(self):
    object.__setattr__(
        self, 'atom_positions', np.asarray(self.atom_positions, np.float64))
    object.__setattr__(
        self, 'atomic_numbers', np.asarray(self.atomic_numbers, np.int32))

  @property
  def num_atoms(self) -> int:
    return self.atom_positions.shape[0]

  def __eq__(self, other) -> bool:
    if not isinstance(other, AtomicGrid):
      return NotImplemented
    if self.num_atoms != other.num_atoms:
      return False
    if self.num_atoms == 0:
      return True
    d, nearest = spatial.cKDTree(other.atom_positions).query(
        self.atom_positions, k=1)
    if len(np.unique(nearest)) != self.num_atoms:
      return False
    return bool((d < 1e-6).all() and (
        self.atomic_numbers == other.atomic_numbers[nearest]).all())

  def __hash__(self):
    return hash((self.num_atoms, self.atomic_numbers.sum()))


@dataclasses.dataclass(frozen=True)
class BeamControl:
  """Beam position (2,) + dwell (+ optional voltage and current)."""

  position: np.ndarray
  dwell_time: dt.timedelta
  voltage_kv: Optional[float] = None
  current_na: Optional[float] = None

  def __post_init__(self):
    object.__setattr__(
        self, 'position', np.asarray(self.position, np.float64).reshape(2))


@dataclasses.dataclass(frozen=True)
class MicroscopeFieldOfView:
  """FOV corners in angstroms with frame-conversion helpers."""

  lower_left: np.ndarray
  upper_right: np.ndarray

  def __post_init__(self):
    object.__setattr__(
        self, 'lower_left', np.asarray(self.lower_left, np.float64).reshape(2))
    object.__setattr__(
        self, 'upper_right',
        np.asarray(self.upper_right, np.float64).reshape(2))

  @property
  def width(self) -> float:
    return float(self.upper_right[0] - self.lower_left[0])

  @property
  def height(self) -> float:
    return float(self.upper_right[1] - self.lower_left[1])

  @property
  def offset(self) -> np.ndarray:
    return (self.lower_left + self.upper_right) / 2.0

  def shift(self, delta: np.ndarray) -> 'MicroscopeFieldOfView':
    delta = np.asarray(delta).reshape(2)
    return MicroscopeFieldOfView(
        self.lower_left + delta, self.upper_right + delta)

  def resize(self, new_width: float, new_height: float
             ) -> 'MicroscopeFieldOfView':
    if not (new_width > 0 and new_height > 0):
      raise ValueError(f'FOV size must be positive: {new_width, new_height}')
    half = np.asarray([new_width, new_height]) / 2.0
    center = self.offset
    return MicroscopeFieldOfView(center - half, center + half)

  def zoom(self, zoom_factor: float) -> 'MicroscopeFieldOfView':
    if not zoom_factor > 0:
      raise ValueError(f'zoom_factor must be positive: {zoom_factor}')
    return self.resize(self.width / zoom_factor, self.height / zoom_factor)

  def microscope_frame_to_material_frame(self, point):
    """[0,1]^2 -> angstroms; accepts (.., 2) arrays, AtomicGrid, BeamControl."""
    scale = self.upper_right - self.lower_left
    if isinstance(point, AtomicGrid):
      return AtomicGrid(point.atom_positions * scale + self.lower_left,
                        point.atomic_numbers)
    if isinstance(point, BeamControl):
      return dataclasses.replace(
          point, position=point.position * scale + self.lower_left)
    return np.asarray(point, np.float64) * scale + self.lower_left

  def material_frame_to_microscope_frame(self, point):
    """Angstroms -> [0,1]^2; accepts (.., 2) arrays, AtomicGrid, BeamControl."""
    scale = self.upper_right - self.lower_left
    if isinstance(point, AtomicGrid):
      return AtomicGrid((point.atom_positions - self.lower_left) / scale,
                        point.atomic_numbers)
    if isinstance(point, BeamControl):
      return dataclasses.replace(
          point, position=(point.position - self.lower_left) / scale)
    return (np.asarray(point, np.float64) - self.lower_left) / scale

  def get_atoms_in_bounds(self, grid: AtomicGrid, tolerance: float = 0.0
                          ) -> AtomicGrid:
    """The material-frame atoms inside the FOV grown by `tolerance`."""
    lo = self.lower_left - tolerance
    hi = self.upper_right + tolerance
    keep = np.all((grid.atom_positions >= lo) & (grid.atom_positions <= hi),
                  axis=1)
    return AtomicGrid(grid.atom_positions[keep], grid.atomic_numbers[keep])

  def __str__(self) -> str:
    ll, ur = self.lower_left, self.upper_right
    return f'FOV [({ll[0]:.2f}, {ll[1]:.2f}), ({ur[0]:.2f}, {ur[1]:.2f})]'


@dataclasses.dataclass(frozen=True)
class MicroscopeObservation:
  """One observation from the (real or simulated) microscope; the grid's
  positions are in the microscope frame."""

  grid: AtomicGrid
  fov: MicroscopeFieldOfView
  controls: Tuple[BeamControl, ...]
  elapsed_time: dt.timedelta
  image: Optional[np.ndarray] = None
  label_image: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class Transition:
  """A before/after pair of observations under applied controls."""

  grid_before: AtomicGrid
  grid_after: AtomicGrid
  fov_before: MicroscopeFieldOfView
  fov_after: MicroscopeFieldOfView
  controls: Tuple[BeamControl, ...]
  image_before: Optional[np.ndarray] = None
  image_after: Optional[np.ndarray] = None
  label_image_before: Optional[np.ndarray] = None
  label_image_after: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class Trajectory:
  """A sequence of observations."""

  observations: Sequence[MicroscopeObservation]


@dataclasses.dataclass(frozen=True)
class Drift:
  """Global drift (2,) + per-atom jitter (N, 2) labels, angstroms."""

  drift: np.ndarray
  jitter: np.ndarray

  def __post_init__(self):
    object.__setattr__(
        self, 'drift', np.asarray(self.drift, np.float64).reshape(2))
    object.__setattr__(
        self, 'jitter', np.asarray(self.jitter, np.float64).reshape(-1, 2))

  def apply_to_observation(self, observation: MicroscopeObservation
                           ) -> MicroscopeObservation:
    """Shifts the FOV by `drift` and each atom by its jitter."""
    new_fov = observation.fov.shift(self.drift)
    scale = np.asarray([new_fov.width, new_fov.height])
    jitter_microscope = self.jitter / scale
    if jitter_microscope.shape[0] != observation.grid.num_atoms:
      raise ValueError(
          'Drift jitter must have one row per atom: '
          f'{jitter_microscope.shape[0]} != {observation.grid.num_atoms}')
    new_grid = AtomicGrid(
        observation.grid.atom_positions + jitter_microscope,
        observation.grid.atomic_numbers)
    return dataclasses.replace(observation, grid=new_grid, fov=new_fov)


@dataclasses.dataclass(frozen=True)
class LabeledAlignmentTrajectory:
  """A trajectory with one drift label per observation (the JAX package's,
  without its proto methods)."""

  trajectory: Trajectory
  drifts: Sequence[Drift]


def get_silicon_positions(grid: AtomicGrid) -> np.ndarray:
  return grid.atom_positions[grid.atomic_numbers == constants.SILICON]


class SiliconNotFoundError(RuntimeError):
  """No silicon atom in the grid."""


def get_single_silicon_position(grid: AtomicGrid) -> np.ndarray:
  """The silicon's position; with several, the one nearest the centre
  (0.5, 0.5); raises SiliconNotFoundError with none."""
  positions = get_silicon_positions(grid)
  if positions.shape[0] == 0:
    raise SiliconNotFoundError()
  if positions.shape[0] > 1:
    i = int(np.linalg.norm(positions - np.asarray([[0.5, 0.5]]),
                           axis=1).argmin())
    positions = positions[i:i + 1]
  return positions.reshape(2)


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)


def observation_from_device(
    window,
    fov,
    elapsed_seconds,
    batch_index: int = 0,
    controls: Tuple[BeamControl, ...] = (),
    image=None,
) -> MicroscopeObservation:
  """One batch element of the device observation parts in host form.

  window: structures.AtomWindow; fov: structures.FieldOfView;
  elapsed_seconds: (B,); image: optional (B, H, W). Tensors or arrays.
  """
  b = batch_index
  mask = _host(window.mask)[b]
  grid = AtomicGrid(_host(window.positions)[b][mask],
                    _host(window.atomic_numbers)[b][mask])
  host_fov = MicroscopeFieldOfView(_host(fov.lower_left)[b],
                                   _host(fov.upper_right)[b])
  return MicroscopeObservation(
      grid=grid,
      fov=host_fov,
      controls=controls,
      elapsed_time=dt.timedelta(
          seconds=float(_host(elapsed_seconds)[b])),
      image=None if image is None else _host(image)[b],
  )
