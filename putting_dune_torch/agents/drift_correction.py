"""In-loop drift correction: image alignment inside the control loop.

Port of putting_dune_tpu/agents/drift_correction.py. The simulator's drift
(simulator.py, SimulatorConfig.drift_per_frame_angstroms) corrupts one
thing a relative-control agent depends on: the goal delta, recorded in the
instrument frame at episode start, goes stale by the cumulative drift.
This module estimates that drift on the device, batched and without a host
sync, from the frames the agent already receives, and repairs the goal
delta before the base policy sees it.

Estimator: phase correlation between consecutive frames (`torch.fft`, as
the JAX package leaves its `jnp.fft` to XLA). The believed FOV motion (the
instrument's own scan settings, ImageFeatures(include_fov=True)) is
subtracted, and the correlation peak is searched only within one drift
increment of the expected content shift, which also keeps out the
graphene lattice's aliases. Raw noisy frames carry frame-fixed artefacts
(CLAHE tile grid, row jitter) that pull the peak toward zero shift, so the
vision-planner correctors correlate the detector's carbon-class maps,
sharing one UNet pass per frame with the planner.

Array conventions follow imaging/render.py: col = x * S, row = S-1 - y * S
(row 0 is the top of the image).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from putting_dune_torch import eval_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch.agents import planner as planner_lib
from putting_dune_torch.agents import vision_planner as vp
from putting_dune_torch.utils import profiling


def _prep(images: torch.Tensor) -> torch.Tensor:
  """Mean subtraction and a Hann window (less non-circular edge leakage)."""
  s = images.shape[-1]
  idx = torch.arange(s, dtype=torch.float32, device=images.device)
  hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * idx / s)
  win = hann[:, None] * hann[None, :]
  centered = images - torch.mean(images, dim=(-2, -1), keepdim=True)
  return centered * win


def estimate_content_shift_px(
    prev: torch.Tensor,
    cur: torch.Tensor,
    expected_row_col: torch.Tensor,
    max_residual_px: torch.Tensor,
) -> torch.Tensor:
  """Phase-correlation shift of `cur` relative to `prev`, (B, 2) float.

  Args:
    prev: (B, S, S) previous frames (or probability maps).
    cur: (B, S, S) current frames.
    expected_row_col: (B, 2) expected content shift in array (row, col)
      pixels, from the believed FOV motion.
    max_residual_px: (B,) search radius around the expectation.

  Returns:
    (B, 2) measured (row, col) content shift in pixels, sub-pixel refined
    and unwrapped onto the branch nearest the expectation.
  """
  batch, s, _ = prev.shape
  f1 = torch.fft.rfft2(_prep(prev))
  f2 = torch.fft.rfft2(_prep(cur))
  r = f2 * torch.conj(f1)
  r = r / (torch.abs(r) + 1e-8)
  corr = torch.fft.irfft2(r, s=(s, s))  # (B, S, S); peak at the shift

  idx = torch.arange(s, dtype=torch.float32, device=prev.device)

  def wrap(d):
    # Floor modulo (the sign of the divisor), as jnp.mod.
    return torch.remainder(d + s / 2.0, float(s)) - s / 2.0

  drow = wrap(idx[None, :, None] - expected_row_col[:, 0, None, None])
  dcol = wrap(idx[None, None, :] - expected_row_col[:, 1, None, None])
  # A radius under ~1.5 px could hold no pixel centre for a fractional
  # expectation; the clamp keeps the nearest integer shifts in play.
  lim = torch.clamp(max_residual_px, min=1.5)[:, None, None]
  # A circular window: the lattice aliases the correlation at every
  # Bravais translation (2.46 A), which a box's corners would admit.
  ok = (drow * drow + dcol * dcol) <= lim * lim
  score = torch.where(ok, corr, torch.full_like(corr, -math.inf))

  # Ties resolve to the first index, as jnp.argmax does.
  flat = torch.argmax(score.reshape(batch, -1), dim=-1)
  r0 = torch.div(flat, s, rounding_mode='floor')
  c0 = torch.remainder(flat, s)
  rows = torch.arange(batch, device=prev.device)

  def at(rr, cc):
    return corr[rows, torch.remainder(rr, s), torch.remainder(cc, s)]

  def parabolic(cm, c0v, cp):
    denom = cm - 2.0 * c0v + cp
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (cm - cp) / denom,
                      torch.zeros_like(denom))
    return torch.clamp(off, -0.5, 0.5)

  row = r0.to(torch.float32) + parabolic(
      at(r0 - 1, c0), at(r0, c0), at(r0 + 1, c0))
  col = c0.to(torch.float32) + parabolic(
      at(r0, c0 - 1), at(r0, c0), at(r0, c0 + 1))
  measured = torch.stack([row, col], dim=-1)
  return expected_row_col + wrap(measured - expected_row_col)


class DriftTracker:
  """Functions of the (prev_map, prev_ll, drift) carry, shared by the
  generic wrapper and the vision-planner policies."""

  def __init__(self, max_increment_angstroms: float = 1.0):
    self.max_increment_angstroms = max_increment_angstroms

  def init(self, maps: torch.Tensor, obs) -> dict:
    return dict(
        prev_map=maps,
        prev_ll=obs['fov_lower_left'],
        drift=torch.zeros_like(obs['goal_delta_angstroms']),
    )

  def update(self, pstate: dict, maps: torch.Tensor, obs, first) -> dict:
    s = maps.shape[-1]
    ll = obs['fov_lower_left']
    width = (obs['fov_upper_right'] - ll)[..., 0]  # (B,) square FOV

    # Expected content shift from the instrument's own FOV motion, in
    # microscope units: u = (w - ll + D) / width.
    b_u = (pstate['prev_ll'] - ll) / width[..., None]  # (B, 2)
    expected_rc = torch.stack([-b_u[..., 1] * s, b_u[..., 0] * s], dim=-1)
    max_res_px = self.max_increment_angstroms * s / width
    with profiling.span('policy.drift_correction'):
      shift_rc = estimate_content_shift_px(
          pstate['prev_map'], maps, expected_rc, max_res_px)
    s_u = torch.stack([shift_rc[..., 1] / s, -shift_rc[..., 0] / s], dim=-1)
    increment = width[..., None] * (s_u - b_u)  # the drift's, angstroms

    drift = pstate['drift'] + increment
    # Fresh episodes start drift-calibrated (the simulator resets to 0).
    drift = torch.where(first[..., None], torch.zeros_like(drift), drift)
    return dict(prev_map=maps, prev_ll=ll, drift=drift)


class DriftCorrectedPolicy(eval_lib.StatefulPolicy):
  """Wraps an image policy with on-device cumulative-drift correction.

  Requires ImageFeatures(include_fov=True) observations. map_fn extracts
  the (B, S, S) correlation map from the observation; the default (raw
  frames) is only reliable on lightly noised images, see
  DriftCorrectedVisionPlannerPolicy.
  """

  def __init__(
      self,
      base_policy: Callable[[Any, Any], torch.Tensor],
      *,
      map_fn: Optional[Callable[[Any], torch.Tensor]] = None,
      max_increment_angstroms: float = 1.0,
  ):
    self._base = base_policy
    self._map_fn = map_fn or (lambda obs: obs['image'][..., 0])
    self._tracker = DriftTracker(max_increment_angstroms)

  def init(self, example_obs):
    return self._tracker.init(self._map_fn(example_obs), example_obs)

  def step(self, pstate, gen, obs, first):
    new_state = self._tracker.update(pstate, self._map_fn(obs), obs, first)
    corrected = dict(obs)
    corrected['goal_delta_angstroms'] = (
        obs['goal_delta_angstroms'] + new_state['drift'])
    return new_state, self._base(gen, corrected)


class DriftCorrectedVisionPlannerPolicy(eval_lib.StatefulPolicy):
  """Vision planner with in-loop drift correction, one detector pass.

  Per frame: detector -> class probability maps; phase correlation of the
  carbon map against the previous frame's (less the believed FOV motion)
  accumulates the drift estimate; the planner runs on the same maps with
  the de-drifted goal, snapped to the honeycomb.
  """

  def __init__(
      self,
      *,
      detector_fn,
      rate_fn: rates_lib.RateFunction,
      dwell_seconds: float,
      max_distance_angstroms: float,
      candidates,
      max_increment_angstroms: float = 1.0,
  ):
    self._detector_fn = detector_fn
    self._rate_fn = rate_fn
    self._dwell_seconds = dwell_seconds
    self._max_distance = max_distance_angstroms
    self._candidates = candidates
    self._tracker = DriftTracker(max_increment_angstroms)

  def _probs(self, obs):
    return vp.detect(self._detector_fn, obs['image'])

  def init(self, example_obs):
    return self._tracker.init(self._probs(example_obs)[..., 1], example_obs)

  def step(self, pstate, gen, obs, first):
    del gen
    with profiling.span('policy.step'):
      probs = self._probs(obs)
      new_state = self._tracker.update(pstate, probs[..., 1], obs, first)
      action = vp.vision_planner_policy_from_probs(
          probs,
          obs['goal_delta_angstroms'] + new_state['drift'],
          rate_fn=self._rate_fn,
          dwell_seconds=self._dwell_seconds,
          max_distance_angstroms=self._max_distance,
          candidates=self._candidates,
          # Goal displacements are exact honeycomb vectors: snapping the
          # de-drifted goal absorbs the corrector's sub-half-site residual.
          snap_goal_to_lattice=True,
      )
      return new_state, action


class DriftCorrectedMultiDopantVisionPlannerPolicy(eval_lib.StatefulPolicy):
  """D-dopant vision planner with in-loop drift correction.

  As the single-dopant one, with one (B, 2) drift carry: the estimate
  repairs the live goal deltas (latched dopants read exactly zero and stay
  zero; `live` comes from the uncorrected deltas), and the anchor's
  de-drifted goal snaps to the honeycomb.
  """

  def __init__(
      self,
      *,
      detector_fn,
      rate_fn: rates_lib.RateFunction,
      num_dopants: int,
      dwell_seconds: float,
      max_distance_angstroms: float,
      candidates,
      min_separation_px: float = 6.0,
      max_increment_angstroms: float = 1.0,
  ):
    self._detector_fn = detector_fn
    self._rate_fn = rate_fn
    self._num_dopants = num_dopants
    self._dwell_seconds = dwell_seconds
    self._max_distance = max_distance_angstroms
    self._candidates = candidates
    self._min_separation_px = min_separation_px
    self._tracker = DriftTracker(max_increment_angstroms)

  def _probs(self, obs):
    return vp.detect(self._detector_fn, obs['image'])

  def init(self, example_obs):
    pstate = self._tracker.init(self._probs(example_obs)[..., 1], example_obs)
    # goal_delta is (B, D*2); one (B, 2) drift vector is tracked.
    delta = example_obs['goal_delta_angstroms']
    pstate['drift'] = torch.zeros((delta.shape[0], 2), dtype=torch.float32,
                                  device=delta.device)
    return pstate

  def step(self, pstate, gen, obs, first):
    del gen
    with profiling.span('policy.step'):
      probs = self._probs(obs)
      new_state = self._tracker.update(pstate, probs[..., 1], obs, first)
      batch = probs.shape[0]
      deltas = obs['goal_delta_angstroms'].reshape(
          batch, self._num_dopants, 2)
      live = torch.linalg.vector_norm(deltas, dim=-1) > 1e-6  # uncorrected
      corrected = torch.where(
          live[..., None], deltas + new_state['drift'][:, None, :],
          torch.zeros_like(deltas))
      action = vp.multi_dopant_vision_planner_policy_from_probs(
          probs,
          corrected,
          rate_fn=self._rate_fn,
          num_dopants=self._num_dopants,
          dwell_seconds=self._dwell_seconds,
          max_distance_angstroms=self._max_distance,
          candidates=self._candidates,
          min_separation_px=self._min_separation_px,
          live=live,
          snap_goal_to_lattice=True,
      )
      return new_state, action


@dataclasses.dataclass
class DriftCorrectedMultiDopantVisionPlannerAgent:
  """Registry agent: D-dopant vision planner + in-loop drift correction."""

  rate_fn: rates_lib.RateFunction
  num_dopants: int
  dwell_seconds: float = 5.0
  max_distance_angstroms: Optional[float] = None
  weights_dir: Optional[str] = None
  min_separation_px: float = 6.0
  max_increment_angstroms: float = 1.0
  device: Optional[str] = None

  def __post_init__(self):
    self._detector_fn = vp.load_shipped_detector(self.weights_dir, self.device)
    if self.max_distance_angstroms is None:
      self.max_distance_angstroms = 2.0 * vp.BOND
    self._candidates = planner_lib.make_candidate_offsets(
        max_radius=self.max_distance_angstroms)

  def policy(self) -> DriftCorrectedMultiDopantVisionPlannerPolicy:
    return DriftCorrectedMultiDopantVisionPlannerPolicy(
        detector_fn=self._detector_fn,
        rate_fn=self.rate_fn,
        num_dopants=self.num_dopants,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=self.max_distance_angstroms,
        candidates=self._candidates,
        min_separation_px=self.min_separation_px,
        max_increment_angstroms=self.max_increment_angstroms,
    )


@dataclasses.dataclass
class DriftCorrectedVisionPlannerAgent:
  """Registry agent: vision planner + in-loop drift correction (drifting
  microscope -> pixels -> shipped UNet -> lattice geometry and drift
  estimate -> rate-aware planner). `policy()` is a StatefulPolicy."""

  rate_fn: rates_lib.RateFunction
  dwell_seconds: float = 5.0
  max_distance_angstroms: Optional[float] = None
  weights_dir: Optional[str] = None
  max_increment_angstroms: float = 1.0
  device: Optional[str] = None

  def __post_init__(self):
    self._detector_fn = vp.load_shipped_detector(self.weights_dir, self.device)
    if self.max_distance_angstroms is None:
      self.max_distance_angstroms = 2.0 * vp.BOND
    self._candidates = planner_lib.make_candidate_offsets(
        max_radius=self.max_distance_angstroms)

  def policy(self) -> DriftCorrectedVisionPlannerPolicy:
    return DriftCorrectedVisionPlannerPolicy(
        detector_fn=self._detector_fn,
        rate_fn=self.rate_fn,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=self.max_distance_angstroms,
        candidates=self._candidates,
        max_increment_angstroms=self.max_increment_angstroms,
    )
