"""Vision planner: pixels -> detector maps -> lattice geometry -> planning.

Port of putting_dune_tpu/agents/vision_planner.py.
The shipped segmentation UNet turns the STEM frame into class probability
maps; closed-form harmonic analysis of those maps recovers the silicon
position, the lattice scale and the bond orientation; the rate-aware
planner (agents/planner.py) then optimizes the beam on that geometry:

  * silicon position: sharpened soft-argmax of the Si-class map;
  * lattice scale: first peak of the carbon-mass radial histogram about
    the silicon (the bond length in pixels);
  * bond orientation: the third angular harmonic of carbon mass in the
    bond annulus (its argument / 3 is the neighbor angle set).

For D dopants `extract_peaks` finds the D silicon peaks, and the lattice
frame is measured at the anchor peak (the first one, in the env's
lexicographic position order, whose goal delta is live).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import torch

from putting_dune_torch import constants
from putting_dune_torch import device as device_lib
from putting_dune_torch import rates as rates_lib
from putting_dune_torch.agents import eval_agent
from putting_dune_torch.agents import planner as planner_lib
from putting_dune_torch.atom_detection import model as det_model
from putting_dune_torch.atom_detection import train as det_train
from putting_dune_torch.utils import profiling

BOND = constants.CARBON_BOND_DISTANCE_ANGSTROMS

SHIPPED_DETECTOR_DIR = os.path.join(
    eval_agent.MODEL_WEIGHTS_DIR, 'atom_detector')


def estimate_lattice_frame(
    p_si: torch.Tensor,
    p_carbon: torch.Tensor,
    *,
    min_bond_px: float = 4.0,
    max_bond_px: float = 40.0,
    sharpen: float = 4.0,
):
  """Recovers (si_xy_px, bond_px, theta0) from class probability maps.

  Coordinates are math-frame pixels: x right (columns), y up (row 0 is
  the image top), matching the material frame's axis orientation.

  Args:
    p_si: (B, S, S) silicon-class probabilities.
    p_carbon: (B, S, S) carbon-class probabilities.
    min_bond_px / max_bond_px: radial search window for the bond peak.
    sharpen: soft-argmax sharpening exponent for the Si position.

  Returns:
    si_xy: (B, 2) silicon position, math-frame pixels.
    bond_px: (B,) estimated bond length, pixels.
    theta0: (B,) bond orientation (one representative of the 3-fold set).
  """
  b, s, _ = p_si.shape
  device = p_si.device
  xs = torch.arange(s, dtype=torch.float32, device=device) + 0.5
  x = xs[None, :].expand(s, s)
  y = (s - xs)[:, None].expand(s, s)  # row 0 = top

  w = torch.pow(torch.clamp(p_si, min=0.0), sharpen)
  wsum = torch.clamp(torch.sum(w, dim=(1, 2)), min=1e-12)
  si_x = torch.sum(w * x[None], dim=(1, 2)) / wsum
  si_y = torch.sum(w * y[None], dim=(1, 2)) / wsum
  si_xy = torch.stack([si_x, si_y], dim=-1)

  dx = x[None] - si_x[:, None, None]
  dy = y[None] - si_y[:, None, None]
  r = torch.sqrt(dx * dx + dy * dy)

  # Radial histogram of carbon mass, 1-px triangular bins, as two
  # scatter-adds per image (floor and ceil bins).
  nbins = int(max_bond_px) + 2
  centers = torch.arange(nbins, dtype=torch.float32, device=device)
  rc = torch.clamp(r, 0.0, float(nbins - 1) - 1e-3)
  lo = torch.floor(rc)
  frac = (rc - lo).reshape(b, -1)
  lo_idx = lo.to(torch.int64).reshape(b, -1)
  pc_flat = p_carbon.reshape(b, -1)
  hist = torch.zeros((b, nbins), dtype=torch.float32, device=device)
  hist.scatter_add_(1, lo_idx, pc_flat * (1.0 - frac))
  hist.scatter_add_(1, lo_idx + 1, pc_flat * frac)

  valid = (centers >= min_bond_px) & (centers <= max_bond_px)
  # Mass per unit arc length, not raw mass, so that the first shell's
  # prominence does not depend on the pixel scale.
  hist = hist / torch.clamp(centers, min=1.0)[None]
  hist = torch.where(valid[None], hist, torch.zeros_like(hist))
  # FIRST significant local maximum, not the global one: the second shell
  # (6 atoms at sqrt(3) * bond) is about as prominent as the first. A
  # score that falls with the bin index makes argmax return the first.
  prev = torch.cat([hist[:, :1], hist[:, :-1]], dim=-1)
  nxt = torch.cat([hist[:, 1:], hist[:, -1:]], dim=-1)
  is_max = (hist >= prev) & (hist >= nxt)
  significant = hist > 0.4 * torch.amax(hist, dim=-1, keepdim=True)
  cand_score = torch.where(
      is_max & significant & valid[None],
      (nbins - centers)[None].expand(b, nbins),
      torch.full((), -math.inf, device=device),
  )
  peak = torch.argmax(cand_score, dim=-1)

  # Parabolic sub-bin refinement around the peak.
  h0 = torch.gather(hist, 1, peak[:, None])[:, 0]
  hm = torch.gather(hist, 1, torch.clamp(peak - 1, min=0)[:, None])[:, 0]
  hp = torch.gather(
      hist, 1, torch.clamp(peak + 1, max=nbins - 1)[:, None])[:, 0]
  hm = torch.where(torch.isfinite(hm), hm, h0)
  hp = torch.where(torch.isfinite(hp), hp, h0)
  denom = hm - 2.0 * h0 + hp
  shift = torch.where(
      torch.abs(denom) > 1e-9, 0.5 * (hm - hp) / denom,
      torch.zeros_like(denom),
  )
  bond_px = peak.to(torch.float32) + torch.clamp(shift, -0.5, 0.5)

  # Third angular harmonic of carbon mass in the bond annulus.
  bond = bond_px[:, None, None]
  ann = p_carbon * torch.exp(-0.5 * torch.square((r - bond) / (0.25 * bond)))
  phi = torch.atan2(dy, dx)
  zr = torch.sum(ann * torch.cos(3.0 * phi), dim=(1, 2))
  zi = torch.sum(ann * torch.sin(3.0 * phi), dim=(1, 2))
  theta0 = torch.atan2(zi, zr) / 3.0
  return si_xy, bond_px, theta0


def load_shipped_detector(
    weights_dir: Optional[str] = None,
    device=None,
    *,
    allow_tf32: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
  """Loads the shipped UNet atom detector as a (B, S, S, 1) -> logits fn.

  Args:
    weights_dir: a directory with params.msgpack (+ arch.json); defaults
      to the detector shipped with the JAX package, read in place.
    device: defaults to CUDA and raises if it is absent unless 'cpu'.
    allow_tf32: let cuDNN run the float32 convolutions on the tensor cores
      in TF32 (CUDA only; 6x faster on an H100 and the same pixel accuracy,
      logits within 1e-2 of full float32). False keeps full float32 and
      lets cuDNN pick its fastest algorithm by trial at the first call.
  """
  device = device_lib.resolve_device(device)
  workdir = weights_dir or SHIPPED_DETECTOR_DIR
  if not os.path.isdir(workdir):
    raise FileNotFoundError(f'No atom detector at {workdir}.')
  params = det_train.load_params(workdir)
  arch = det_train.load_arch(workdir)
  features = (tuple(arch['features']) if arch
              else det_model.features_from_flax(params))
  module = det_model.UNet(features=features)
  module.load_state_dict(det_model.params_from_flax(params))
  module = module.to(device).eval()

  def detector_fn(image: torch.Tensor) -> torch.Tensor:
    # `flags` defaults to enabled=False: cuDNN has to be asked for. Without
    # TF32 and without the trial, cuDNN's heuristic takes an FFT algorithm
    # here that is slower than no cuDNN at all and needs 35 GB at batch 100.
    with torch.no_grad(), torch.backends.cudnn.flags(
        enabled=True, benchmark=not allow_tf32, allow_tf32=allow_tf32):
      return module(image)

  return detector_fn


def detect(detector_fn, image: torch.Tensor) -> torch.Tensor:
  """(B, S, S, 3) class probabilities of (B, S, S, 1) frames."""
  with profiling.span('policy.detector'):
    return torch.softmax(detector_fn(image), dim=-1)


def _pixel_grid(size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
  """Math-frame pixel centres (x right, y up; row 0 is the image top)."""
  xs = torch.arange(size, dtype=torch.float32, device=device) + 0.5
  return xs[None, :].expand(size, size), (size - xs)[:, None].expand(size, size)


def extract_peaks(
    p_map: torch.Tensor,
    num_peaks: int,
    min_separation_px: float,
    sharpen: float = 4.0,
) -> torch.Tensor:
  """Extracts num_peaks distinct maxima from (B, S, S) probability maps.

  Iterative suppression: a hard argmax locates each peak, a sharpened
  soft-argmax over the surrounding half-separation disk refines it to
  sub-pixel, then the full separation disk is zeroed for later rounds.

  Returns:
    (B, num_peaks, 2) math-frame pixel positions (x right, y up), in
    extraction order (descending peak height).
  """
  b, s, _ = p_map.shape
  x, y = _pixel_grid(s, p_map.device)
  x_flat, y_flat = x.reshape(-1), y.reshape(-1)
  remaining = torch.clamp(p_map, min=0.0)
  peaks = []
  for _ in range(num_peaks):
    idx = torch.argmax(remaining.reshape(b, -1), dim=-1)  # (B,)
    cx, cy = x_flat[idx], y_flat[idx]
    r2 = (torch.square(x[None] - cx[:, None, None])
          + torch.square(y[None] - cy[:, None, None]))
    refine = r2 < (0.5 * min_separation_px) ** 2
    w = torch.pow(
        torch.where(refine, remaining, torch.zeros_like(remaining)), sharpen)
    wsum = torch.clamp(torch.sum(w, dim=(1, 2)), min=1e-12)
    px = torch.sum(w * x[None], dim=(1, 2)) / wsum
    py = torch.sum(w * y[None], dim=(1, 2)) / wsum
    peaks.append(torch.stack([px, py], dim=-1))
    remaining = torch.where(
        r2 < min_separation_px ** 2, torch.zeros_like(remaining), remaining)
  return torch.stack(peaks, dim=1)


def snap_to_honeycomb(delta: torch.Tensor, theta0: torch.Tensor
                      ) -> torch.Tensor:
  """Snaps (B, 2) displacement vectors to the nearest honeycomb vector.

  Site-to-site displacements in graphene are exactly {m*a1 + n*a2} (same
  sublattice) or {m*a1 + n*a2 + b0} (opposite), with b0 the bond vector
  at the detected bond orientation theta0 and a1/a2 the Bravais vectors
  built from the bond set.
  """
  def e(theta):
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)

  b0 = BOND * e(theta0)  # (B, 2)
  b1 = BOND * e(theta0 + 2.0 * math.pi / 3.0)
  b2 = BOND * e(theta0 + 4.0 * math.pi / 3.0)
  a1 = b0 - b1
  a2 = b0 - b2
  det = a1[..., 0] * a2[..., 1] - a1[..., 1] * a2[..., 0]  # (B,)

  best = None
  best_d2 = None
  for sub in (0.0, 1.0):
    g = delta - sub * b0
    c1 = (a2[..., 1] * g[..., 0] - a2[..., 0] * g[..., 1]) / det
    c2 = (-a1[..., 1] * g[..., 0] + a1[..., 0] * g[..., 1]) / det
    f1 = torch.floor(c1)
    f2 = torch.floor(c2)
    for d1 in (0.0, 1.0):
      for d2 in (0.0, 1.0):
        cand = (
            (f1 + d1)[..., None] * a1
            + (f2 + d2)[..., None] * a2
            + sub * b0
        )
        dist2 = torch.sum(torch.square(cand - delta), dim=-1)
        if best is None:
          best, best_d2 = cand, dist2
        else:
          take = dist2 < best_d2
          best = torch.where(take[..., None], cand, best)
          best_d2 = torch.minimum(best_d2, dist2)
  return best


def _plan_from_frame(
    theta0: torch.Tensor,
    goal_delta: torch.Tensor,
    *,
    rate_fn: rates_lib.RateFunction,
    dwell_seconds: float,
    max_distance_angstroms: float,
    candidates,
    snap_goal_to_lattice: bool,
) -> torch.Tensor:
  """Plans on the detected bond orientation: the three neighbor deltas at
  theta0 + {0, 120, 240} degrees, one bond long (the detected lattice
  calibrates the pixel scale itself), with the silicon at the origin."""
  batch, device = theta0.shape[0], theta0.device
  # A copy from host memory waits for the device: a host sync.
  with profiling.span('sync.planner_angles'):
    thirds = torch.tensor(
        [0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0], device=device)
  angles = theta0[:, None] + thirds  # (B, 3)
  deltas = BOND * torch.stack(
      [torch.cos(angles), torch.sin(angles)], dim=-1
  )  # (B, 3, 2)
  if snap_goal_to_lattice:
    goal_delta = snap_to_honeycomb(goal_delta, theta0)
  single_obs = torch.cat(
      [
          torch.zeros((batch, 2), device=device),  # relative geometry
          deltas.reshape(batch, 6),
          goal_delta,
      ],
      dim=-1,
  )
  action_angstroms = planner_lib.planner_policy(
      None,
      single_obs,
      rate_fn=rate_fn,
      dwell_seconds=dwell_seconds,
      candidates=candidates,
  )
  return action_angstroms / max_distance_angstroms


def vision_planner_policy_from_probs(
    probs: torch.Tensor,
    goal_delta: torch.Tensor,
    *,
    rate_fn: rates_lib.RateFunction,
    dwell_seconds: float,
    max_distance_angstroms: float,
    candidates,
    snap_goal_to_lattice: bool = False,
) -> torch.Tensor:
  """Planner core over precomputed class-probability maps.

  probs: (B, S, S, 3) softmaxed segmentation maps; goal_delta: (B, 2)
  angstroms. snap_goal_to_lattice snaps the goal vector to the nearest
  exact site displacement (see snap_to_honeycomb). Returns (B, 2) actions
  in units of max_distance_angstroms.
  """
  with profiling.span('policy.lattice_frame'):
    _, _, theta0 = estimate_lattice_frame(probs[..., 2], probs[..., 1])
  with profiling.span('policy.planner'):
    return _plan_from_frame(
        theta0, goal_delta, rate_fn=rate_fn, dwell_seconds=dwell_seconds,
        max_distance_angstroms=max_distance_angstroms, candidates=candidates,
        snap_goal_to_lattice=snap_goal_to_lattice)


def vision_planner_policy(
    gen: Optional[torch.Generator],
    observation,
    *,
    detector_fn,
    rate_fn: rates_lib.RateFunction,
    dwell_seconds: float,
    max_distance_angstroms: float,
    candidates,
) -> torch.Tensor:
  """Batched policy over ImageFeatures observations.

  Args:
    gen: unused.
    observation: {'image': (B, S, S, 1), 'goal_delta_angstroms': (B, 2)}.
    detector_fn: (B, S, S, 1) -> (B, S, S, 3) segmentation logits
      (background, carbon, silicon), e.g. `load_shipped_detector()`.
    rate_fn: planning model.
    dwell_seconds: the adapter's fixed dwell.
    max_distance_angstroms: the adapter's action scale (actions are
      emitted in units of it).
    candidates: (K, 2) beam offsets, angstroms.

  Returns:
    (B, 2) actions in units of max_distance_angstroms.
  """
  del gen
  with profiling.span('policy.step'):
    probs = detect(detector_fn, observation['image'])
    return vision_planner_policy_from_probs(
        probs,
        observation['goal_delta_angstroms'],
        rate_fn=rate_fn,
        dwell_seconds=dwell_seconds,
        max_distance_angstroms=max_distance_angstroms,
        candidates=candidates,
    )


def multi_dopant_vision_planner_policy_from_probs(
    probs: torch.Tensor,
    deltas: torch.Tensor,
    *,
    rate_fn: rates_lib.RateFunction,
    num_dopants: int,
    dwell_seconds: float,
    max_distance_angstroms: float,
    candidates,
    min_separation_px: float = 6.0,
    live: Optional[torch.Tensor] = None,
    snap_goal_to_lattice: bool = False,
) -> torch.Tensor:
  """D-dopant planner core over precomputed class-probability maps.

  probs: (B, S, S, 3); deltas: (B, D, 2) goal deltas in position order.
  `live` overrides the latched-dopant mask (norm > 1e-6 by default; a
  caller that adds a correction to the deltas passes the mask of the
  uncorrected ones, since latched entries read exactly zero);
  snap_goal_to_lattice snaps the anchor's goal vector to the nearest exact
  site displacement. Returns (B, 2) actions in units of
  max_distance_angstroms.
  """
  batch = probs.shape[0]
  device = probs.device
  p_carbon, p_si = probs[..., 1], probs[..., 2]

  peaks = extract_peaks(p_si, num_dopants, min_separation_px)
  # The env's lexicographic (x, y) order (MultiDopantEnv._position_key).
  lex = peaks[..., 0] * 4096.0 + peaks[..., 1]
  order = torch.argsort(lex, dim=-1, stable=True)
  peaks = torch.gather(peaks, 1, order[..., None].expand(-1, -1, 2))

  if live is None:
    live = torch.linalg.vector_norm(deltas, dim=-1) > 1e-6  # (B, D)
  pick = torch.argmax(live.to(torch.int32), dim=-1)  # first unlatched
  rows = torch.arange(batch, device=device)
  anchor_px = peaks[rows, pick]
  goal_delta = deltas[rows, pick]

  # Local lattice frame at the anchor: the Si map is masked to the
  # anchor's disk, so the soft-argmax and the carbon histograms centre on
  # it (other dopants are silicon-class and leave the carbon shells alone).
  x, y = _pixel_grid(p_si.shape[1], device)
  r2 = (torch.square(x[None] - anchor_px[:, 0][:, None, None])
        + torch.square(y[None] - anchor_px[:, 1][:, None, None]))
  masked_si = torch.where(
      r2 < (0.5 * min_separation_px) ** 2, p_si, torch.zeros_like(p_si))
  with profiling.span('policy.lattice_frame'):
    _, _, theta0 = estimate_lattice_frame(masked_si, p_carbon)
  with profiling.span('policy.planner'):
    return _plan_from_frame(
        theta0, goal_delta, rate_fn=rate_fn, dwell_seconds=dwell_seconds,
        max_distance_angstroms=max_distance_angstroms, candidates=candidates,
        snap_goal_to_lattice=snap_goal_to_lattice)


def multi_dopant_vision_planner_policy(
    gen: Optional[torch.Generator],
    observation,
    *,
    detector_fn,
    rate_fn: rates_lib.RateFunction,
    num_dopants: int,
    dwell_seconds: float,
    max_distance_angstroms: float,
    candidates,
    min_separation_px: float = 6.0,
) -> torch.Tensor:
  """Pixels to control for the D-dopant env, with no training.

  Requires the env's anchor_order='position': the env lists goal deltas in
  lexicographic dopant-position order and anchors 'relative' actions on
  the first unlatched dopant in that order, which this policy reproduces
  from the detected peaks alone.

  Args:
    observation: {'image': (B, S, S, 1),
                  'goal_delta_angstroms': (B, D*2)}, position-ordered.

  Returns:
    (B, 2) actions in units of max_distance_angstroms (beam offset from
    the anchor dopant).
  """
  del gen
  with profiling.span('policy.step'):
    image = observation['image']
    deltas = observation['goal_delta_angstroms'].reshape(
        image.shape[0], num_dopants, 2)
    probs = detect(detector_fn, image)
    return multi_dopant_vision_planner_policy_from_probs(
        probs, deltas, rate_fn=rate_fn, num_dopants=num_dopants,
        dwell_seconds=dwell_seconds,
        max_distance_angstroms=max_distance_angstroms, candidates=candidates,
        min_separation_px=min_separation_px,
    )


@dataclasses.dataclass
class MultiDopantVisionPlannerAgent:
  """Registry agent: pixels to control for the D-dopant env. Requires the
  env's anchor_order='position' and 'image' observations."""

  rate_fn: rates_lib.RateFunction
  num_dopants: int
  dwell_seconds: float = 5.0
  max_distance_angstroms: float = 2.0 * BOND
  weights_dir: Optional[str] = None
  min_separation_px: float = 6.0
  device: Optional[str] = None

  def __post_init__(self):
    self._detector_fn = load_shipped_detector(self.weights_dir, self.device)
    self._candidates = planner_lib.make_candidate_offsets(
        max_radius=self.max_distance_angstroms
    )

  def policy(self):
    return lambda gen, obs: multi_dopant_vision_planner_policy(
        gen,
        obs,
        detector_fn=self._detector_fn,
        rate_fn=self.rate_fn,
        num_dopants=self.num_dopants,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=self.max_distance_angstroms,
        candidates=self._candidates,
        min_separation_px=self.min_separation_px,
    )


@dataclasses.dataclass
class VisionPlannerAgent:
  """Registry agent: shipped-detector-backed vision planner; `policy()` is
  the batched policy for eval_lib.evaluate_batched."""

  rate_fn: rates_lib.RateFunction
  dwell_seconds: float = 1.5
  max_distance_angstroms: float = BOND
  weights_dir: Optional[str] = None
  device: Optional[str] = None

  def __post_init__(self):
    self._detector_fn = load_shipped_detector(self.weights_dir, self.device)
    self._candidates = planner_lib.make_candidate_offsets(
        max_radius=self.max_distance_angstroms
    )

  def policy(self):
    return lambda gen, obs: vision_planner_policy(
        gen,
        obs,
        detector_fn=self._detector_fn,
        rate_fn=self.rate_fn,
        dwell_seconds=self.dwell_seconds,
        max_distance_angstroms=self.max_distance_angstroms,
        candidates=self._candidates,
    )
