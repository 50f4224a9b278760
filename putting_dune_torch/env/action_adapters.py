"""Action adapters: agent action -> beam control, batched.

Port of putting_dune_tpu/env/action_adapters.py. Each adapter has

    spec()                          -> ActionSpec
    init_state(gen, batch_size)     -> per-env adapter state (or None)
    to_controls(state, ctx, action) -> (new_state, BeamControl)

The dwell is a fixed 1.5 s unless the adapter exposes dwell-time control
(a 3rd action dim).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from putting_dune_torch import constants
from putting_dune_torch import structures

DEFAULT_DWELL_SECONDS = 1.5


@dataclasses.dataclass(frozen=True)
class ActionSpec:
  """Bounded action spec."""

  shape: tuple[int, ...]
  minimum: tuple[float, ...] | float
  maximum: tuple[float, ...] | float
  dtype: type = np.float32


@dataclasses.dataclass
class AdapterContext:
  """The pieces of the previous observation adapters may use.

  Attributes:
    si_position_microscope: (B, 2).
    fov: current field of view.
  """

  si_position_microscope: torch.Tensor
  fov: structures.FieldOfView


def _dwell_from_action(action: torch.Tensor, min_dwell: float,
                       max_dwell: float) -> torch.Tensor:
  """Maps an optional 3rd action dim to dwell seconds."""
  if min_dwell == max_dwell:
    return torch.full(action.shape[:-1], min_dwell, dtype=torch.float32,
                      device=action.device)
  frac = torch.clamp(action[..., 2], 0.0, 1.0)
  return frac * (max_dwell - min_dwell) + min_dwell


@dataclasses.dataclass(frozen=True)
class DirectActionAdapter:
  """Absolute [0, 1]^2 beam placement at a fixed dwell."""

  dwell_seconds: float = DEFAULT_DWELL_SECONDS

  def spec(self) -> ActionSpec:
    return ActionSpec((2,), 0.0, 1.0)

  def init_state(self, gen, batch_size: int):
    del gen, batch_size
    return None

  def to_controls(self, state, ctx: AdapterContext, action: torch.Tensor):
    del ctx
    position = torch.clamp(action, 0.0, 1.0)
    dwell = torch.full(action.shape[:-1], self.dwell_seconds,
                       dtype=torch.float32, device=action.device)
    return state, structures.BeamControl(position, dwell)


@dataclasses.dataclass(frozen=True)
class DeltaPositionActionAdapter:
  """A beam moved by a clipped delta. Its position persists across steps
  and is drawn anew, U(0, 1)^2, when an episode starts."""

  dwell_seconds: float = DEFAULT_DWELL_SECONDS

  def spec(self) -> ActionSpec:
    return ActionSpec((2,), -0.1, 0.1)

  def init_state(self, gen: torch.Generator, batch_size: int):
    return torch.rand((batch_size, 2), generator=gen, device=gen.device)

  def to_controls(self, state, ctx: AdapterContext, action: torch.Tensor):
    del ctx
    beam = torch.clamp(state + action, 0.0, 1.0)
    dwell = torch.full(action.shape[:-1], self.dwell_seconds,
                       dtype=torch.float32, device=action.device)
    return beam, structures.BeamControl(beam, dwell)


@dataclasses.dataclass(frozen=True)
class RelativeToSiliconActionAdapter:
  """Beam at silicon + action * max_distance, in the microscope frame."""

  min_dwell_seconds: float = DEFAULT_DWELL_SECONDS
  max_dwell_seconds: float = DEFAULT_DWELL_SECONDS
  max_distance_angstroms: float = constants.CARBON_BOND_DISTANCE_ANGSTROMS

  @property
  def fixed_dwell(self) -> bool:
    return self.min_dwell_seconds == self.max_dwell_seconds

  def spec(self) -> ActionSpec:
    if self.fixed_dwell:
      return ActionSpec((2,), -1.0, 1.0)
    return ActionSpec((3,), (-1.0, -1.0, 0.0), (1.0, 1.0, 1.0))

  def init_state(self, gen, batch_size: int):
    del gen, batch_size
    return None

  def to_controls(self, state, ctx: AdapterContext, action: torch.Tensor):
    delta = torch.clamp(action[..., :2], -1.0, 1.0)
    extent = torch.stack([ctx.fov.width, ctx.fov.height], dim=-1)
    cell_radius = self.max_distance_angstroms / extent
    position = torch.clamp(
        ctx.si_position_microscope + delta * cell_radius, 0.0, 1.0
    )
    dwell = _dwell_from_action(action, self.min_dwell_seconds,
                               self.max_dwell_seconds)
    return state, structures.BeamControl(position, dwell)


@dataclasses.dataclass(frozen=True)
class RelativeToSiliconMaterialFrameActionAdapter(
    RelativeToSiliconActionAdapter
):
  """Beam at silicon + action angstroms (material frame)."""

  def spec(self) -> ActionSpec:
    if self.fixed_dwell:
      return ActionSpec((2,), -10.0, 10.0)
    return ActionSpec((3,), (-10.0, -10.0, 0.0), (10.0, 10.0, 1.0))

  def to_controls(self, state, ctx: AdapterContext, action: torch.Tensor):
    si_material = ctx.fov.microscope_to_material(ctx.si_position_microscope)
    target = si_material + action[..., :2]
    position = torch.clamp(ctx.fov.material_to_microscope(target), 0.0, 1.0)
    dwell = _dwell_from_action(action, self.min_dwell_seconds,
                               self.max_dwell_seconds)
    return state, structures.BeamControl(position, dwell)
