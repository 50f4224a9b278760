"""State structures for the batched simulator: dataclasses of tensors.

Port of putting_dune_tpu/structures.py. Every structure holds tensors with
a leading batch dimension; ragged data (atoms inside the field of view) is
fixed-capacity tensors plus validity masks. `tree_map` walks nested
dataclasses leaf by leaf, the counterpart of jax.tree_util.tree_map that
the environment's auto-reset uses to select and scatter whole states.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from putting_dune_torch import geometry


def tree_map(fn: Callable[..., Any], tree, *rest):
  """Applies fn leafwise over matching dataclass / tensor trees.

  None leaves stay None. Non-tensor, non-container leaves are taken from
  the first tree unchanged.
  """
  if tree is None:
    return None
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    kwargs = {
        f.name: tree_map(
            fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest]
        )
        for f in dataclasses.fields(tree)
    }
    return type(tree)(**kwargs)
  if isinstance(tree, torch.Tensor):
    return fn(tree, *rest)
  return tree


@dataclasses.dataclass
class FieldOfView:
  """Batched microscope field of view.

  Attributes:
    lower_left: (..., 2) material-frame angstroms.
    upper_right: (..., 2) material-frame angstroms.
  """

  lower_left: torch.Tensor
  upper_right: torch.Tensor

  @property
  def width(self) -> torch.Tensor:
    return self.upper_right[..., 0] - self.lower_left[..., 0]

  @property
  def height(self) -> torch.Tensor:
    return self.upper_right[..., 1] - self.lower_left[..., 1]

  @property
  def offset(self) -> torch.Tensor:
    """Center of the FOV, (..., 2)."""
    return (self.lower_left + self.upper_right) / 2.0

  def shift(self, delta: torch.Tensor) -> 'FieldOfView':
    return FieldOfView(self.lower_left + delta, self.upper_right + delta)

  def resize(self, new_width, new_height) -> 'FieldOfView':
    """Resizes around the current center; a scalar size broadcasts over
    the batch."""
    like = self.lower_left
    half = torch.stack(
        [torch.broadcast_to(torch.as_tensor(size, dtype=like.dtype,
                                            device=like.device),
                            self.width.shape)
         for size in (new_width, new_height)], dim=-1) / 2.0
    center = self.offset
    return FieldOfView(center - half, center + half)

  def zoom(self, zoom_factor) -> 'FieldOfView':
    return self.resize(self.width / zoom_factor, self.height / zoom_factor)

  def microscope_to_material(self, point: torch.Tensor) -> torch.Tensor:
    return geometry.microscope_to_material(
        point, self.lower_left, self.upper_right)

  def material_to_microscope(self, point: torch.Tensor) -> torch.Tensor:
    return geometry.material_to_microscope(
        point, self.lower_left, self.upper_right)


@dataclasses.dataclass
class BeamControl:
  """A beam position + dwell command.

  Attributes:
    position: (B, 2); adapters emit the microscope frame, the KMC core
      takes the material frame.
    dwell_seconds: (B,) seconds, float32.
    voltage_kv: (B,) or None.
    current_na: (B,) or None.
  """

  position: torch.Tensor
  dwell_seconds: torch.Tensor
  voltage_kv: Optional[torch.Tensor] = None
  current_na: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MaterialState:
  """Pristine single-doped graphene state, O(1) per environment.

  World positions are implicit: (canonical + offset) rotated by theta.

  Attributes:
    offset: (B, 2) per-episode lattice offset, angstroms.
    theta: (B,) per-episode lattice rotation, radians.
    si_index: (B,) int64 lattice site currently holding the silicon.
  """

  offset: torch.Tensor
  theta: torch.Tensor
  si_index: torch.Tensor


@dataclasses.dataclass
class AtomWindow:
  """Fixed-capacity view of the atoms inside a FOV (masked, batched).

  Attributes:
    positions: (B, K, 2) microscope-frame coordinates in [0, 1].
    atomic_numbers: (B, K) int32 (6 = C, 14 = Si); padding slots are 0.
    mask: (B, K) bool, True for real atoms.
    si_slot: (B,) int64 slot index of the silicon, -1 if not in view.
  """

  positions: torch.Tensor
  atomic_numbers: torch.Tensor
  mask: torch.Tensor
  si_slot: torch.Tensor


@dataclasses.dataclass
class ImagingParams:
  """Per-episode STEM image domain-randomization parameters, (B,) f32."""

  intensity_exponent: torch.Tensor
  gaussian_variance: torch.Tensor
  jitter_rate: torch.Tensor
  poisson_rate_multiplier: torch.Tensor
  salt_and_pepper_amount: torch.Tensor
  blur_amount: torch.Tensor
  contrast_gamma: torch.Tensor
  exponential_lambda: torch.Tensor
  uniform_noise_scale: torch.Tensor


@dataclasses.dataclass
class MicroscopeObservation:
  """What the simulated microscope reports after a step.

  Attributes:
    fov: current field of view.
    si_position_microscope: (B, 2) silicon position in [0,1]^2.
    neighbor_positions_microscope: (B, 3, 2) its 3 neighbors.
    elapsed_seconds: (B,) simulated seconds consumed by the step.
    silicon_in_view: (B,) bool.
    last_controls: the controls applied this step (microscope frame);
      None after a reset, and on the observation the env steps on.
    window: optional AtomWindow crop of the FOV.
    image: optional (B, H, W) rendered STEM image.
  """

  fov: FieldOfView
  si_position_microscope: torch.Tensor
  neighbor_positions_microscope: torch.Tensor
  elapsed_seconds: torch.Tensor
  silicon_in_view: torch.Tensor
  last_controls: Optional[BeamControl] = None
  window: Optional[AtomWindow] = None
  image: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SimulatorState:
  """Full simulator state between steps.

  Attributes:
    material: lattice pose + dopant site.
    fov: the field of view the instrument believes it images.
    imaging: per-episode image randomization parameters.
    drift: (B, 2) cumulative instrument drift, material-frame angstroms:
      the true offset between the believed FOV and where the sample sits.
      Observations are built from the drifted world; physics (KMC, goals)
      stays in the true frame. Always a tensor (zeros without drift), so
      that `tree_map` selects and scatters it on auto-reset.
  """

  material: MaterialState
  fov: FieldOfView
  imaging: ImagingParams
  drift: torch.Tensor
