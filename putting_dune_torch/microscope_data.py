"""Host-side microscope data structures (numpy dataclasses).

Port of putting_dune_tpu/microscope_data.py: atomic grids, beam controls,
fields of view with their frame conversions, observations, transitions,
trajectories, drift labels and labeled alignment trajectories, with the
same fields, equality and hashes.
This is the boundary between the batched device simulator (structures.py)
and the real-microscope loop and the offline pipelines; frames are by
convention ("microscope" = [0, 1]^2, "material" = angstroms).

Every dataclass but the FOV helpers' inputs round-trips through the wire
schema (`to_proto`, `from_proto`, `to_proto_bytes`, `from_proto_bytes`) on
the port's own codec (`proto/wire.py`), byte for byte as the JAX package
writes. Image fields are written as the `NDArray` message, or as
`tensorflow.TensorProto` inside `with image_wire_format('tensorproto')`;
reads take either (`io/tensorproto.py`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime as dt
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import spatial

from putting_dune_torch import constants
from putting_dune_torch.io import tensorproto as tensorproto_lib
from putting_dune_torch.proto import wire


# --- ndarray <-> proto -------------------------------------------------------


def ndarray_to_proto(array: Optional[np.ndarray]) -> Optional[wire.NDArray]:
  if array is None:
    return None
  return tensorproto_lib.ndarray_message(array)


def proto_to_ndarray(msg: Optional[wire.NDArray]) -> Optional[np.ndarray]:
  if msg is None or not msg.dtype:
    return None
  return np.frombuffer(msg.data, dtype=np.dtype(msg.dtype)).reshape(
      tuple(msg.shape))


# --- image wire format -------------------------------------------------------

_image_wire_format: contextvars.ContextVar[str] = contextvars.ContextVar(
    'image_wire_format', default=tensorproto_lib.NDARRAY_FORMAT)


@contextlib.contextmanager
def image_wire_format(fmt: str):
  """Selects the on-wire encoding of image fields for writes in scope:
  'ndarray' (the default) or 'tensorproto' (what upstream putting-dune
  writes and reads)."""
  if fmt not in (tensorproto_lib.NDARRAY_FORMAT,
                 tensorproto_lib.TENSORPROTO_FORMAT):
    raise ValueError(f'Unknown image wire format {fmt!r}')
  token = _image_wire_format.set(fmt)
  try:
    yield
  finally:
    _image_wire_format.reset(token)


def _encode_image(array: np.ndarray) -> bytes:
  return tensorproto_lib.encode_image_bytes(array, _image_wire_format.get())


_decode_image = tensorproto_lib.decode_image_bytes


def _point_to_proto(p: np.ndarray) -> wire.Point2D:
  return wire.Point2D(x=float(p[0]), y=float(p[1]))


def _proto_to_point(msg: wire.Point2D) -> np.ndarray:
  return np.asarray([msg.x, msg.y], dtype=np.float64)


class ProtoModel:
  """Serialization through the wire schema; `ProtoMessage` is the class's
  message."""

  ProtoMessage = wire.Message

  def to_proto(self):
    raise NotImplementedError

  @classmethod
  def from_proto(cls, msg):
    raise NotImplementedError

  def to_proto_bytes(self) -> bytes:
    return self.to_proto().SerializeToString()

  @classmethod
  def from_proto_bytes(cls, data: bytes):
    return cls.from_proto(cls.ProtoMessage.FromString(data))


# One atom of an AtomicGrid on the wire, for atomic numbers 0-127: tag of
# AtomicGrid.atoms, length 14, tag of Atom.atomic_number, the number, tag
# of Atom.position, length 10, tag of Point2D.x, x (float32), tag of
# Point2D.y, y (float32).
_ATOM_ROW = np.asarray([0x0A, 0x0E, 0x08, 0, 0x12, 0x0A, 0x0D, 0, 0, 0, 0,
                        0x15, 0, 0, 0, 0], np.uint8)
_ATOM_TAGS = [0, 1, 2, 4, 5, 6, 11]


def _grid_field(grid: 'AtomicGrid'):
  return wire.encoded(wire.AtomicGrid, grid.to_proto_bytes())


@dataclasses.dataclass(frozen=True)
class AtomicGrid(ProtoModel):
  """Atom positions (N, 2) + atomic numbers (N,).

  Two grids are equal when each atom has a distinct nearest atom of the
  same species in the other, closer than 1e-6.
  """

  ProtoMessage = wire.AtomicGrid

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

  def to_proto(self) -> wire.AtomicGrid:
    return wire.AtomicGrid(atoms=[
        wire.Atom(atomic_number=int(num), position=_point_to_proto(pos))
        for pos, num in zip(self.atom_positions, self.atomic_numbers)])

  def to_proto_bytes(self) -> bytes:
    """The bytes of `to_proto()`, built in one numpy pass when every atomic
    number is a one-byte varint (0-127): each atom is then the same 16
    bytes, two of them its float32 coordinates."""
    numbers = self.atomic_numbers
    if not ((numbers >= 0) & (numbers < 128)).all():
      return self.to_proto().SerializeToString()
    rows = np.empty((self.num_atoms, 16), np.uint8)
    rows[:] = _ATOM_ROW
    rows[:, 3] = numbers
    xy = self.atom_positions.astype('<f4').view(np.uint8).reshape(-1, 8)
    rows[:, 7:11] = xy[:, :4]
    rows[:, 12:16] = xy[:, 4:]
    return rows.tobytes()

  @classmethod
  def from_proto_bytes(cls, data: bytes) -> 'AtomicGrid':
    """Reads the 16-byte atoms `to_proto_bytes` writes in one numpy pass;
    any other encoding goes through the codec."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size % 16 == 0:
      rows = rows.reshape(-1, 16)
      if ((rows[:, _ATOM_TAGS] == _ATOM_ROW[_ATOM_TAGS]).all()
          and (rows[:, 3] < 128).all()):
        xy = np.ascontiguousarray(
            np.concatenate([rows[:, 7:11], rows[:, 12:16]], axis=1))
        return cls(xy.view('<f4').astype(np.float64),
                   rows[:, 3].astype(np.int32))
    return cls.from_proto(wire.AtomicGrid.FromString(data))

  @classmethod
  def from_proto(cls, msg: wire.AtomicGrid) -> 'AtomicGrid':
    atoms = msg.atoms
    positions = np.zeros((len(atoms), 2))
    numbers = np.zeros((len(atoms),), np.int32)
    for i, atom in enumerate(atoms):
      positions[i] = (atom.position.x, atom.position.y)
      numbers[i] = atom.atomic_number
    return cls(positions, numbers)


@dataclasses.dataclass(frozen=True)
class BeamControl(ProtoModel):
  """Beam position (2,) + dwell (+ optional voltage and current)."""

  ProtoMessage = wire.BeamControl

  position: np.ndarray
  dwell_time: dt.timedelta
  voltage_kv: Optional[float] = None
  current_na: Optional[float] = None

  def __post_init__(self):
    object.__setattr__(
        self, 'position', np.asarray(self.position, np.float64).reshape(2))

  def to_proto(self) -> wire.BeamControl:
    # An unset voltage or current stays unset on the wire (not a zero).
    return wire.BeamControl(
        position=_point_to_proto(self.position),
        dwell_time_seconds=self.dwell_time.total_seconds(),
        voltage_kv=self.voltage_kv, current_na=self.current_na)

  @classmethod
  def from_proto(cls, msg: wire.BeamControl) -> 'BeamControl':
    return cls(
        position=_proto_to_point(msg.position),
        dwell_time=dt.timedelta(seconds=msg.dwell_time_seconds),
        voltage_kv=msg.voltage_kv if msg.HasField('voltage_kv') else None,
        current_na=msg.current_na if msg.HasField('current_na') else None)


@dataclasses.dataclass(frozen=True)
class MicroscopeFieldOfView(ProtoModel):
  """FOV corners in angstroms with frame-conversion helpers."""

  ProtoMessage = wire.FieldOfView

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

  def to_proto(self) -> wire.FieldOfView:
    return wire.FieldOfView(
        lower_left_angstroms=_point_to_proto(self.lower_left),
        upper_right_angstroms=_point_to_proto(self.upper_right))

  @classmethod
  def from_proto(cls, msg: wire.FieldOfView) -> 'MicroscopeFieldOfView':
    return cls(_proto_to_point(msg.lower_left_angstroms),
               _proto_to_point(msg.upper_right_angstroms))


@dataclasses.dataclass(frozen=True)
class MicroscopeObservation(ProtoModel):
  """One observation from the (real or simulated) microscope; the grid's
  positions are in the microscope frame."""

  ProtoMessage = wire.MicroscopeObservation

  grid: AtomicGrid
  fov: MicroscopeFieldOfView
  controls: Tuple[BeamControl, ...]
  elapsed_time: dt.timedelta
  image: Optional[np.ndarray] = None
  label_image: Optional[np.ndarray] = None

  def to_proto(self) -> wire.MicroscopeObservation:
    return wire.MicroscopeObservation(
        grid=_grid_field(self.grid),
        fov=self.fov.to_proto(),
        controls=[c.to_proto() for c in self.controls],
        elapsed_time_seconds=self.elapsed_time.total_seconds(),
        image=None if self.image is None else _encode_image(self.image),
        label_image=(None if self.label_image is None
                     else _encode_image(self.label_image)))

  @classmethod
  def from_proto(cls, msg: wire.MicroscopeObservation
                 ) -> 'MicroscopeObservation':
    return cls(
        grid=AtomicGrid.from_proto_bytes(msg.raw('grid')),
        fov=MicroscopeFieldOfView.from_proto(msg.fov),
        controls=tuple(BeamControl.from_proto(c) for c in msg.controls),
        elapsed_time=dt.timedelta(seconds=msg.elapsed_time_seconds),
        image=_decode_image(msg.image) if msg.HasField('image') else None,
        label_image=(_decode_image(msg.label_image)
                     if msg.HasField('label_image') else None))


_TRANSITION_IMAGES = ('image_before', 'image_after', 'label_image_before',
                      'label_image_after')


@dataclasses.dataclass(frozen=True)
class Transition(ProtoModel):
  """A before/after pair of observations under applied controls."""

  ProtoMessage = wire.Transition

  grid_before: AtomicGrid
  grid_after: AtomicGrid
  fov_before: MicroscopeFieldOfView
  fov_after: MicroscopeFieldOfView
  controls: Tuple[BeamControl, ...]
  image_before: Optional[np.ndarray] = None
  image_after: Optional[np.ndarray] = None
  label_image_before: Optional[np.ndarray] = None
  label_image_after: Optional[np.ndarray] = None

  def to_proto(self) -> wire.Transition:
    images = {name: _encode_image(getattr(self, name))
              for name in _TRANSITION_IMAGES
              if getattr(self, name) is not None}
    return wire.Transition(
        grid_before=_grid_field(self.grid_before),
        grid_after=_grid_field(self.grid_after),
        fov_before=self.fov_before.to_proto(),
        fov_after=self.fov_after.to_proto(),
        controls=[c.to_proto() for c in self.controls], **images)

  @classmethod
  def from_proto(cls, msg: wire.Transition) -> 'Transition':
    images = {name: _decode_image(getattr(msg, name))
              for name in _TRANSITION_IMAGES if msg.HasField(name)}
    return cls(
        grid_before=AtomicGrid.from_proto_bytes(msg.raw('grid_before')),
        grid_after=AtomicGrid.from_proto_bytes(msg.raw('grid_after')),
        fov_before=MicroscopeFieldOfView.from_proto(msg.fov_before),
        fov_after=MicroscopeFieldOfView.from_proto(msg.fov_after),
        controls=tuple(BeamControl.from_proto(c) for c in msg.controls),
        **images)


@dataclasses.dataclass(frozen=True)
class Trajectory(ProtoModel):
  """A sequence of observations."""

  ProtoMessage = wire.Trajectory

  observations: Sequence[MicroscopeObservation]

  def to_proto(self) -> wire.Trajectory:
    return wire.Trajectory(
        observations=[o.to_proto() for o in self.observations])

  @classmethod
  def from_proto(cls, msg: wire.Trajectory) -> 'Trajectory':
    return cls(observations=tuple(
        MicroscopeObservation.from_proto(o) for o in msg.observations))


@dataclasses.dataclass(frozen=True)
class Drift(ProtoModel):
  """Global drift (2,) + per-atom jitter (N, 2) labels, angstroms."""

  ProtoMessage = wire.Drift

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

  def to_proto(self) -> wire.Drift:
    return wire.Drift(drift=_point_to_proto(self.drift),
                      jitter=[_point_to_proto(j) for j in self.jitter])

  @classmethod
  def from_proto(cls, msg: wire.Drift) -> 'Drift':
    return cls(drift=_proto_to_point(msg.drift),
               jitter=np.asarray([[p.x, p.y] for p in msg.jitter],
                                 np.float64).reshape(-1, 2))


@dataclasses.dataclass(frozen=True)
class LabeledAlignmentTrajectory(ProtoModel):
  """A trajectory with one drift label per observation."""

  ProtoMessage = wire.LabeledAlignmentTrajectory

  trajectory: Trajectory
  drifts: Sequence[Drift]

  def to_proto(self) -> wire.LabeledAlignmentTrajectory:
    return wire.LabeledAlignmentTrajectory(
        trajectory=self.trajectory.to_proto(),
        drifts=[d.to_proto() for d in self.drifts])

  @classmethod
  def from_proto(cls, msg: wire.LabeledAlignmentTrajectory
                 ) -> 'LabeledAlignmentTrajectory':
    return cls(trajectory=Trajectory.from_proto(msg.trajectory),
               drifts=tuple(Drift.from_proto(d) for d in msg.drifts))


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
