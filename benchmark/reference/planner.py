"""The vision planner's geometry and objective in plain PyTorch.

From the detector's class probabilities: the silicon by a sharpened
soft-argmax (exponent 4); the bond length in pixels by the first
significant (> 0.4 of the largest) local maximum of the carbon mass's
radial histogram (1-pixel triangular bins, mass per unit radius, 4 to 40
pixels), refined by a parabola; the bond orientation theta0 as a third of
the argument of the third angular harmonic of the carbon mass in a
Gaussian annulus (width a quarter bond) about that radius. The planner
scores beam offsets c from the silicon by the expected progress of the
first KMC transition within the dwell, with the three neighbours one bond
from the silicon at theta0 + {0, 120, 240} degrees:

    score(c) = sum_i r_i(c) / R(c) (1 - exp(-R(c) dwell)) (|g| - |g - n_i|)

under the inverse-square law r_i = 1 / ((4 |c - n_i| / bond)^2 + 1).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference import precision as precision_lib

BOND = 1.42


def candidates(max_radius: float, num_radii: int = 10, num_angles: int = 64,
               min_radius: float = 0.3) -> np.ndarray:
  """(K, 2) polar grid of beam offsets, radius-major, in angstroms."""
  radii = np.linspace(min_radius, max_radius, num_radii, dtype=np.float32)
  angles = np.linspace(0.0, 2.0 * np.pi, num_angles, endpoint=False,
                       dtype=np.float32)
  rr, aa = np.meshgrid(radii, angles, indexing='ij')
  return np.stack([rr * np.cos(aa), rr * np.sin(aa)], -1).reshape(-1, 2)


def bond_orientation(p_si: torch.Tensor, p_c: torch.Tensor,
                     precision: str = 'float32') -> torch.Tensor:
  """theta0 (B,) of (B, S, S) silicon and carbon probability maps; every
  intermediate rounded to `precision`."""
  r = functools.partial(precision_lib.round_to, precision=precision)
  p_si, p_c = r(p_si), r(p_c)
  b, s, _ = p_si.shape
  dev = p_si.device
  xs = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
  x = xs[None, :].expand(s, s)
  y = (s - xs)[:, None].expand(s, s)
  w = r(torch.pow(torch.clamp(p_si, min=0.0), 4.0))
  wsum = torch.clamp(w.sum(dim=(1, 2)), min=1e-12)
  cx = r((w * x).sum(dim=(1, 2)) / wsum)
  cy = r((w * y).sum(dim=(1, 2)) / wsum)
  dx, dy = x[None] - cx[:, None, None], y[None] - cy[:, None, None]
  dist = r(torch.sqrt(dx * dx + dy * dy))

  nbins = 42
  centers = torch.arange(nbins, dtype=torch.float32, device=dev)
  rc = torch.clamp(dist, 0.0, nbins - 1 - 1e-3)
  lo = torch.floor(rc)
  frac = (rc - lo).reshape(b, -1)
  idx = lo.to(torch.int64).reshape(b, -1)
  mass = p_c.reshape(b, -1)
  hist = torch.zeros((b, nbins), device=dev)
  hist.scatter_add_(1, idx, mass * (1.0 - frac))
  hist.scatter_add_(1, idx + 1, mass * frac)
  valid = (centers >= 4.0) & (centers <= 40.0)
  hist = r(torch.where(valid[None],
                       hist / torch.clamp(centers, min=1.0)[None],
                       torch.zeros_like(hist)))
  prev = torch.cat([hist[:, :1], hist[:, :-1]], -1)
  nxt = torch.cat([hist[:, 1:], hist[:, -1:]], -1)
  candidate = ((hist >= prev) & (hist >= nxt) & valid[None]
               & (hist > 0.4 * hist.amax(-1, keepdim=True)))
  score = torch.where(candidate, (nbins - centers)[None].expand(b, nbins),
                      torch.full((), -math.inf, device=dev))
  peak = torch.argmax(score, -1)
  h0 = torch.gather(hist, 1, peak[:, None])[:, 0]
  hm = torch.gather(hist, 1, torch.clamp(peak - 1, min=0)[:, None])[:, 0]
  hp = torch.gather(hist, 1,
                    torch.clamp(peak + 1, max=nbins - 1)[:, None])[:, 0]
  denom = hm - 2.0 * h0 + hp
  shift = torch.where(denom.abs() > 1e-9, 0.5 * (hm - hp) / denom,
                      torch.zeros_like(denom))
  bond = r(peak.to(torch.float32)
           + torch.clamp(shift, -0.5, 0.5))[:, None, None]
  ring = r(p_c * torch.exp(-0.5 * torch.square((dist - bond)
                                                / (0.25 * bond))))
  phi = r(torch.atan2(dy, dx))
  re = r((ring * torch.cos(3.0 * phi)).sum(dim=(1, 2)))
  im = r((ring * torch.sin(3.0 * phi)).sum(dim=(1, 2)))
  return r(torch.atan2(im, re) / 3.0)


def scores(theta0: torch.Tensor, goal: torch.Tensor, beam: torch.Tensor,
           dwell: float, precision: str = 'float32') -> torch.Tensor:
  """Expected first-hop progress (B, K) of beam offsets (B, K, 2); every
  intermediate rounded to `precision`."""
  r = functools.partial(precision_lib.round_to, precision=precision)
  angles = r(theta0[:, None] + torch.tensor(
      [0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0], device=theta0.device))
  nbr = r(BOND * torch.stack([torch.cos(angles), torch.sin(angles)], -1))
  dist = r(torch.linalg.vector_norm(r(beam)[:, :, None, :] - nbr[:, None],
                                    dim=-1))
  rates = r(1.0 / (torch.square(dist / BOND * 4.0) + 1.0))  # (B, K, 3)
  total = r(rates.sum(-1))
  goal = r(goal)
  value = r(torch.linalg.vector_norm(goal, dim=-1)[:, None]
            - torch.linalg.vector_norm(goal[:, None, :] - nbr, dim=-1))
  p_any = r(1.0 - torch.exp(-total * dwell))
  return r(torch.sum(r(rates / total[..., None]) * p_any[..., None]
                     * value[:, None, :], -1))
