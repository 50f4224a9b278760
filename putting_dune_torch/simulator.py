"""Batched, functional STEM microscope simulator.

Port of putting_dune_tpu/simulator.py: two functions over a
`SimulatorState` with a leading batch dimension,

    state, obs = reset(gen, lattice, ...)
    state, obs, kmc_result = step(state, gen, control, lattice, ...)

with the JAX package's laws: reset draws a random lattice pose, an FOV
width ~ U(15, 30) angstroms centered on the silicon and fresh imaging
parameters, and charges one image_duration; step converts the
microscope-frame control with the current FOV, runs the KMC for the dwell,
charges dwell + image_duration, and if the silicon left the
[0.25, 0.75]^2 safe area recenters the FOV on it and charges a second
image_duration.

Instrument drift: with `drift_per_frame_angstroms = d > 0` every step adds
a U(-d, d) increment per axis to the cumulative `state.drift` before the
beam lands, drawn from the step's generator ahead of the KMC; with d = 0
nothing extra is drawn, so drift-free runs keep their random stream. The
instrument sees the drifted world through the FOV it believes in: the beam
lands at its believed position less the drift, the safe-area check and
the recentering use the observed silicon (true + drift), and observations
are built through the believed FOV shifted by -drift while reporting the
believed one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from putting_dune_torch import constants
from putting_dune_torch import geometry
from putting_dune_torch import kmc
from putting_dune_torch import lattice as lattice_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch import structures
from putting_dune_torch.imaging import params as imaging_params
from putting_dune_torch.imaging import render as imaging_render


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
  """Static simulator configuration."""

  grid_columns: int = 50
  image_duration_seconds: float = 2.0
  fov_scale_min: float = 15.0
  fov_scale_max: float = 30.0
  # A 30 A FOV holds ~350 atoms; 512 slots give ample headroom.
  window_capacity: int = 512
  image_size: int = 512
  noisy_images: bool = False
  # Per-axis U(-d, d) drift increment added once per step, angstroms;
  # 0.0 disables drift and draws nothing.
  drift_per_frame_angstroms: float = 0.0
  max_kmc_events_per_step: Optional[int] = 10_000


def _fov_around(si_pos: torch.Tensor, scale: torch.Tensor
                ) -> structures.FieldOfView:
  half = scale[..., None] / 2.0
  return structures.FieldOfView(si_pos - half, si_pos + half)


def atom_window(
    lattice: lattice_lib.Lattice,
    material: structures.MaterialState,
    fov: structures.FieldOfView,
    capacity: int,
) -> structures.AtomWindow:
  """Fixed-capacity crop of the atoms inside the FOV (microscope frame).

  In-bounds atoms are scored by descending -index, so top-k returns them
  in ascending lattice-index order; out-of-bounds atoms sort last.
  """
  world = lattice_lib.world_positions(lattice, material.offset, material.theta)
  in_bounds = torch.all(
      (world >= fov.lower_left[..., None, :])
      & (world <= fov.upper_right[..., None, :]),
      dim=-1,
  )  # (B, N)
  n = lattice.num_atoms
  capacity = min(capacity, n)
  order = torch.arange(n, device=world.device)
  score = torch.where(in_bounds, n - order, torch.full_like(order, -1))
  top_scores, indices = torch.topk(score, capacity, dim=-1, sorted=True)
  mask = top_scores > 0

  positions_material = torch.gather(
      world, 1, indices[..., None].expand(-1, -1, 2)
  )
  positions = geometry.material_to_microscope(
      positions_material,
      fov.lower_left[..., None, :],
      fov.upper_right[..., None, :],
  )
  positions = torch.where(mask[..., None], positions,
                          torch.zeros_like(positions))

  is_si = indices == material.si_index[..., None]
  atomic_numbers = torch.where(
      mask,
      torch.where(is_si, constants.SILICON, constants.CARBON),
      0,
  ).to(torch.int32)
  si_here = is_si & mask
  si_slot = torch.where(
      si_here.any(dim=-1), torch.argmax(si_here.to(torch.int32), dim=-1),
      torch.full_like(indices[:, 0], -1),
  )
  return structures.AtomWindow(
      positions=positions, atomic_numbers=atomic_numbers, mask=mask,
      si_slot=si_slot,
  )


def _observe(
    lattice: lattice_lib.Lattice,
    state: structures.SimulatorState,
    elapsed_seconds: torch.Tensor,
    config: SimulatorConfig,
    gen: Optional[torch.Generator],
    *,
    return_window: bool,
    return_image: bool,
    last_controls: Optional[structures.BeamControl] = None,
) -> structures.MicroscopeObservation:
  """Builds the observation for the current state.

  The observation reports the drifted world: observing the world shifted by
  +state.drift in the believed FOV is observing the true world through the
  FOV shifted by -state.drift, so the conversions use the shifted FOV while
  the observation reports the believed one.
  """
  material = state.material
  fov = state.fov.shift(-state.drift)
  si_pos = lattice_lib.site_position(
      lattice, material.si_index, material.offset, material.theta
  )
  nbr_idx = lattice.neighbors[material.si_index]
  nbr_pos = lattice_lib.site_position(
      lattice, nbr_idx, material.offset, material.theta
  )
  si_micro = fov.material_to_microscope(si_pos)
  nbr_micro = geometry.material_to_microscope(
      nbr_pos, fov.lower_left[..., None, :], fov.upper_right[..., None, :]
  )
  silicon_in_view = torch.all((si_micro >= 0.0) & (si_micro <= 1.0), dim=-1)

  window = None
  image = None
  if return_window or return_image:
    window = atom_window(lattice, material, fov, config.window_capacity)
  if return_image:
    if gen is None:
      raise ValueError('return_image requires a generator.')
    image = imaging_render.render_stem_image(
        gen, window, fov, state.imaging, image_size=config.image_size
    )
    if not return_window:
      window = None
  return structures.MicroscopeObservation(
      fov=state.fov,
      si_position_microscope=si_micro,
      neighbor_positions_microscope=nbr_micro,
      elapsed_seconds=elapsed_seconds,
      silicon_in_view=silicon_in_view,
      last_controls=last_controls,
      window=window,
      image=image,
  )


def reset(
    gen: torch.Generator,
    lattice: lattice_lib.Lattice,
    *,
    config: SimulatorConfig = SimulatorConfig(),
    batch_size: int = 1,
    return_window: bool = False,
    return_image: bool = False,
) -> tuple[structures.SimulatorState, structures.MicroscopeObservation]:
  """Resets a batch of simulators to plausible initial states."""
  device = lattice.device
  bond = constants.CARBON_BOND_DISTANCE_ANGSTROMS

  def uniform(shape, lo, hi):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

  offset = uniform((batch_size, 2), -bond / 2.0, bond / 2.0)
  theta = uniform((batch_size,), 0.0, 2.0 * math.pi)
  si_index = lattice_lib.initial_silicon_index(lattice, offset)
  material = structures.MaterialState(offset=offset, theta=theta,
                                      si_index=si_index)
  fov_scale = uniform((batch_size,), config.fov_scale_min,
                      config.fov_scale_max)
  si_pos = lattice_lib.site_position(lattice, si_index, offset, theta)
  fov = _fov_around(si_pos, fov_scale)
  imaging = imaging_params.sample_imaging_params(
      gen, batch_size, device=device, noisy=config.noisy_images
  )
  state = structures.SimulatorState(
      material=material, fov=fov, imaging=imaging,
      drift=torch.zeros((batch_size, 2), device=device))
  elapsed = torch.full((batch_size,), config.image_duration_seconds,
                       device=device)
  obs = _observe(lattice, state, elapsed, config, gen,
                 return_window=return_window, return_image=return_image)
  return state, obs


def step(
    state: structures.SimulatorState,
    gen: torch.Generator,
    control: structures.BeamControl,
    lattice: lattice_lib.Lattice,
    rate_fn: Optional[rates_lib.RateFunction] = None,
    *,
    config: SimulatorConfig = SimulatorConfig(),
    return_window: bool = False,
    return_image: bool = False,
    record_events: int = 0,
) -> tuple[structures.SimulatorState, structures.MicroscopeObservation,
           kmc.KMCResult]:
  """Applies one beam control per environment and re-images.

  control.position is in the MICROSCOPE frame of the current FOV.
  """
  if rate_fn is None:
    rate_fn = rates_lib.prior_rates
  # The drift advances before the beam lands: the controller aimed with
  # the previous frame, so the beam misses by one increment.
  drift = state.drift
  d = config.drift_per_frame_angstroms
  if d > 0.0:
    drift = drift + (torch.rand(control.position.shape, generator=gen,
                                device=drift.device) * (2.0 * d) - d)
  material = state.material
  # Believed-frame coordinates sit at +drift from the true sample frame.
  beam_material = state.fov.microscope_to_material(control.position) - drift
  result = kmc.apply_control(
      gen, lattice, material.offset, material.theta, material.si_index,
      beam_material, control.dwell_seconds, rate_fn,
      record_events=record_events,
      max_events=config.max_kmc_events_per_step,
  )
  material = dataclasses.replace(material, si_index=result.si_index)

  elapsed = control.dwell_seconds + config.image_duration_seconds
  si_pos = lattice_lib.site_position(
      lattice, material.si_index, material.offset, material.theta
  )
  # The instrument checks and recenters on the silicon it observes.
  si_observed = si_pos + drift
  si_micro = state.fov.material_to_microscope(si_observed)
  outside = torch.any((si_micro < 0.25) | (si_micro > 0.75), dim=-1)

  recentered = _fov_around(si_observed, state.fov.width)
  new_fov = structures.FieldOfView(
      lower_left=torch.where(outside[..., None], recentered.lower_left,
                             state.fov.lower_left),
      upper_right=torch.where(outside[..., None], recentered.upper_right,
                              state.fov.upper_right),
  )
  elapsed = elapsed + torch.where(
      outside, config.image_duration_seconds, 0.0
  )
  new_state = structures.SimulatorState(
      material=material, fov=new_fov, imaging=state.imaging, drift=drift)
  obs = _observe(lattice, new_state, elapsed, config, gen,
                 return_window=return_window, return_image=return_image,
                 last_controls=control)
  return new_state, obs, result
