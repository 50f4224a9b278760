"""The observation pipeline in plain PyTorch: graphene lattice, the atoms
in view, the Gaussian splat, the seven-stage noise chain with the draws of
Philox4x32-10, CLAHE and the bilinear downsample.

Everything is recomputed from the simulator's state (lattice pose,
silicon site, field of view, imaging parameters) and the per-frame noise
seeds; only numbers the reference cannot know (the state and the seeds)
come from the run.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference import precision as precision_lib

BOND_ANGSTROMS = 1.42
CARBON, SILICON = 6, 14


# --- the lattice ---------------------------------------------------------------


def graphene_positions_f64(num_cols: int) -> np.ndarray:
  """Centered honeycomb sheet, (N, 2) float64 angstroms: a unit triangular
  grid with every third site of each row removed, scaled by the bond."""
  ratio = math.sqrt(3.0) / 2.0
  num_rows = int(num_cols / ratio)
  x, y = np.meshgrid(np.arange(num_cols), np.arange(num_rows), indexing='xy')
  y = y * ratio
  x = x.astype(np.float64)
  x[1::2, :] += 0.5
  keep = np.ones((num_rows, num_cols), dtype=bool)
  keep[0::2, 0::3] = False
  keep[1::2, 1::3] = False
  pos = np.stack((x[keep], y[keep]), axis=1) * BOND_ANGSTROMS
  return pos - pos.mean(axis=0, keepdims=True)


@functools.lru_cache(maxsize=4)
def graphene_positions(num_cols: int) -> np.ndarray:
  """The sheet in float32, as the simulator holds it."""
  return graphene_positions_f64(num_cols).astype(np.float32)


def world_positions(canon: torch.Tensor, offset: torch.Tensor,
                    theta: torch.Tensor) -> torch.Tensor:
  """(B, N, 2): each frame's sheet shifted by `offset`, then rotated."""
  shifted = canon + offset[:, None, :]
  c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
  x, y = shifted[..., 0], shifted[..., 1]
  return torch.stack([x * c - y * s, x * s + y * c], dim=-1)


def atoms_in_view(canon, offset, theta, si_index, lower_left, upper_right,
                  capacity: int):
  """The atoms inside each field of view in ascending site order, padded
  to `capacity` slots: (positions in [0, 1]^2 (B, K, 2), atomic numbers
  (B, K) with 0 on padding)."""
  world = world_positions(canon, offset, theta)
  inside = torch.all((world >= lower_left[:, None, :])
                     & (world <= upper_right[:, None, :]), dim=-1)
  n = canon.shape[0]
  capacity = min(capacity, n)
  site = torch.arange(n, device=world.device)
  key = torch.where(inside, site, site + n)  # in view first, by site
  order = torch.sort(key, dim=-1).indices[:, :capacity]
  live = torch.gather(inside, 1, order)
  xy = torch.gather(world, 1, order[..., None].expand(-1, -1, 2))
  scale = upper_right - lower_left
  micro = (xy - lower_left[:, None, :]) / scale[:, None, :]
  micro = torch.where(live[..., None], micro, torch.zeros_like(micro))
  z = torch.where(order == si_index[:, None], SILICON, CARBON)
  z = torch.where(live, z, torch.zeros_like(z))
  return micro, z


def splat(micro, z, width, height, exponent, blur, size: int,
          precision: str = 'float32') -> torch.Tensor:
  """Max-normalized clean frames (B, S, S), row 0 the top: each atom a
  separable Gaussian of sigma S / (2.15 extent) (blur added in
  quadrature, cut at 4 sigma) at its pixel bin, weighted Z ** exponent."""
  coords = torch.arange(size, dtype=torch.float32, device=micro.device)
  bx = torch.clamp(torch.floor(micro[..., 0] * size), 0, size - 1)
  by = torch.clamp(torch.floor(micro[..., 1] * size), 0, size - 1)
  sx = torch.sqrt(torch.square(size / (2.15 * width)) + torch.square(blur))
  sy = torch.sqrt(torch.square(size / (2.15 * height)) + torch.square(blur))
  w = torch.where(z > 0, torch.pow(z.to(torch.float32), exponent[:, None]),
                  torch.zeros((), device=micro.device))

  def profile(center, sigma):
    d = coords - center[..., None]
    s = sigma[:, None, None]
    k = torch.exp(-0.5 * torch.square(d / s))
    return torch.where(torch.abs(d) <= torch.floor(4.0 * s + 0.5), k,
                       torch.zeros_like(k))

  gx = precision_lib.round_to(profile(bx, sx), precision)
  gy = precision_lib.round_to(profile(by, sy) * w[..., None], precision)
  with precision_lib.matmul_mode(precision):
    image = torch.bmm(gy.transpose(1, 2), gx)
  image = torch.flip(image, dims=(-2,))
  peak = torch.amax(image, dim=(-2, -1), keepdim=True)
  return image / torch.clamp(peak, min=1e-20)


# --- the noise chain -------------------------------------------------------------

_MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
  lo16 = m * (x & 0xFFFF)
  mid = m * (x >> 16) + (lo16 >> 16)
  return mid >> 16, ((mid & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox(key0, key1, counter):
  """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors that hold
  32-bit words; counter (..., 4). Returns the four output words."""
  c0, c1, c2, c3 = (counter[..., j] for j in range(4))
  k0, k1 = key0, key1
  for rnd in range(10):
    if rnd:
      k0 = (k0 + 0x9E3779B9) & _MASK
      k1 = (k1 + 0xBB67AE85) & _MASK
    hi0, lo0 = _mulhilo(0xD2511F53, c0)
    hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
    c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
  return c0, c1, c2, c3


def _uniform(word):
  return (word >> 9).to(torch.float32) * (1.0 / 8388608.0) + 1.0 / 16777216.0


def _box_muller(u1, u2):
  r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
  return r * torch.cos(2.0 * math.pi * u2), r * torch.sin(2.0 * math.pi * u2)


def draws_from_seeds(seeds: torch.Tensor, height: int, width: int, *,
                     frame_offset: int = 0, frames: int | None = None
                     ) -> dict:
  """The per-pixel and per-row draws of each frame from its 64-bit seed:
  key (low word, high word); counters (pixel, 0, frame, 0) -> Box-Muller
  pair (z_pois cosine, z_gauss sine), u_pois, u_sp; (pixel, 1, frame, 0)
  -> u_un, u_ex; (row, 2, frame, 0) -> u_row and the pair of z_row. The
  frame counter is the frame's index in its batch: `frames` frames from
  `frame_offset` on."""
  b = seeds.shape[0] - frame_offset if frames is None else frames
  seeds = seeds[frame_offset:frame_offset + b].to(torch.int64)
  dev = seeds.device
  k0 = (seeds & _MASK)[:, None]
  k1 = ((seeds >> 32) & _MASK)[:, None]

  def block(count, which):
    counter = torch.zeros((b, count, 4), dtype=torch.int64, device=dev)
    counter[..., 0] = torch.arange(count, device=dev)
    counter[..., 1] = which
    counter[..., 2] = (torch.arange(b, device=dev) + frame_offset)[:, None]
    return [_uniform(w) for w in philox(k0, k1, counter)]

  px = (b, height, width)
  u1, u2, u_pois, u_sp = (u.reshape(px) for u in block(height * width, 0))
  z_pois, z_gauss = _box_muller(u1, u2)
  u_un, u_ex, _, _ = (u.reshape(px) for u in block(height * width, 1))
  u_row, r1, r2, _ = block(height, 2)
  z_row, _ = _box_muller(r1, r2)
  return dict(u_pois=u_pois, z_pois=z_pois, u_sp=u_sp, u_un=u_un, u_ex=u_ex,
              z_gauss=z_gauss, u_row=u_row, z_row=z_row)


def draws_from_uniforms(uniforms) -> dict:
  """The draws of the CPU path, which takes nine uniform fields from the
  torch generator in this order: the two of the pixels' Box-Muller pair,
  u_row, the two of the rows' pair, u_pois, u_sp, u_un, u_ex."""
  tiny = torch.finfo(torch.float32).tiny
  p1, p2, u_row, r1, r2, u_pois, u_sp, u_un, u_ex = (
      u.clamp(min=tiny) for u in uniforms)
  z_pois, z_gauss = _box_muller(p1, p2)
  z_row, _ = _box_muller(r1, r2)
  return dict(u_pois=u_pois, z_pois=z_pois, u_sp=u_sp, u_un=u_un, u_ex=u_ex,
              z_gauss=z_gauss, u_row=u_row, z_row=z_row)


def _poisson(u, z, lam):
  """CDF inversion over 12 terms below lambda 4, a rounded normal above."""
  lam_safe = torch.clamp(lam, min=1e-20)
  pmf = torch.exp(-lam_safe)
  cdf = pmf
  count = torch.zeros_like(lam)
  for k in range(12):
    count = count + (u > cdf).to(lam.dtype)
    pmf = pmf * lam_safe * (1.0 / (k + 1))
    cdf = cdf + pmf
  large = torch.clamp(torch.floor(lam + torch.sqrt(lam_safe) * z + 0.5),
                      min=0.0)
  return torch.where(lam < 4.0, count, large)


def _renorm(image):
  peak = torch.amax(image, dim=(-2, -1), keepdim=True)
  return image / torch.clamp(peak, min=1e-20)


def noise_chain(image, params: dict, draws: dict,
                precision: str = 'float32') -> torch.Tensor:
  """Poisson shot noise, row jitter, salt and pepper, gamma, uniform,
  exponential and Gaussian noise, each with its (B,) parameter."""
  r = functools.partial(precision_lib.round_to, precision=precision)

  def p(name):
    return r(params[name].to(torch.float32))[:, None, None]

  image = r(image)
  image = _renorm(_poisson(draws['u_pois'], draws['z_pois'],
                           r(image * p('poisson_rate_multiplier'))))
  row_lam = torch.ones_like(draws['u_row']) * p('jitter_rate')[:, :, 0]
  shifts = torch.clamp(_poisson(draws['u_row'], draws['z_row'], row_lam)
                       .to(torch.int64), 0, 127)
  w = image.shape[-1]
  lane = torch.arange(w, device=image.device)
  image = torch.gather(image, -1, torch.remainder(lane - shifts[..., None], w))
  u, a = draws['u_sp'], p('salt_and_pepper_amount')
  image = torch.where(u < a / 2.0, torch.ones_like(image), image)
  image = torch.where((u >= a / 2.0) & (u < a), torch.zeros_like(image), image)
  image = torch.where(image <= 0.0, torch.zeros_like(image), torch.exp(
      p('contrast_gamma') * torch.log(torch.clamp(image, min=1e-30))))
  image = _renorm(r(image) + draws['u_un'] * p('uniform_noise_scale'))
  expo = -torch.log(torch.clamp(draws['u_ex'], min=1e-12))
  image = _renorm(r(image) + expo * p('exponential_lambda'))
  return torch.clamp(r(image) + draws['z_gauss']
                     * torch.sqrt(p('gaussian_variance')), 0.0, 1.0)


# --- CLAHE ---------------------------------------------------------------------


def clahe(image: torch.Tensor, clip_limit: float = 0.01, grid: int = 8,
          nbins: int = 256) -> torch.Tensor:
  """Contrast-limited adaptive histogram equalization of (B, H, W) frames
  in [0, 1]: per tile of a grid x grid mesh an nbins histogram clipped at
  max(clip_limit * tile pixels, 1) with the excess spread evenly, its
  normalized cdf as the tile's mapping, and per pixel the bilinear blend
  of the four nearest tiles' mappings (clamped at the border)."""
  b, h, w = image.shape
  th, tw = h // grid, w // grid
  dev = image.device
  bins = torch.clamp((image * nbins).to(torch.int64), 0, nbins - 1)
  tile = ((torch.arange(h, device=dev) // th)[:, None] * grid
          + (torch.arange(w, device=dev) // tw)[None, :])
  flat = ((torch.arange(b, device=dev)[:, None, None] * grid * grid + tile)
          * nbins + bins)
  hist = torch.bincount(flat.reshape(-1), minlength=b * grid * grid * nbins)
  hist = hist.reshape(b, grid * grid, nbins).to(torch.float32)
  clim = float(np.float32(max(clip_limit * th * tw, 1.0)))
  excess = torch.sum(torch.clamp(hist - clim, min=0.0), dim=-1, keepdim=True)
  cdf = torch.cumsum(torch.clamp(hist, max=clim) + excess / nbins, dim=-1)
  lut = (cdf / cdf[..., -1:]).reshape(b, -1)

  def axis(n, t):
    pos = torch.arange(n, device=dev) + t // 2
    blk = pos // t
    frac = ((pos - blk * t).to(torch.float32) + 0.5) / torch.full(
        (), float(t), device=dev)
    return (torch.clamp(blk - 1, 0, grid - 1), torch.clamp(blk, max=grid - 1),
            frac)

  i0, i1, fy = axis(h, th)
  j0, j1, fx = axis(w, tw)
  fy, fx = fy[:, None], fx[None, :]

  def read(i, j):
    idx = (i[:, None] * grid + j[None, :]) * nbins + bins
    return torch.gather(lut, 1, idx.reshape(b, -1)).reshape(b, h, w)

  return (read(i0, j0) * ((1.0 - fy) * (1.0 - fx))
          + read(i0, j1) * ((1.0 - fy) * fx)
          + read(i1, j0) * (fy * (1.0 - fx))
          + read(i1, j1) * (fy * fx))


def downsample(image: torch.Tensor, size: int) -> torch.Tensor:
  """Bilinear resize of square (B, S, S) frames by an integer factor f:
  output pixel i samples source f i + (f - 1) / 2."""
  s = image.shape[-1]
  f = s // size
  if f * size != s:
    raise ValueError(f'{s} is not a multiple of {size}')
  if f == 1:
    return image
  if f % 2:
    return image[:, (f - 1) // 2::f, (f - 1) // 2::f]
  lo = f // 2 - 1
  rows = 0.5 * (image[:, lo::f, :] + image[:, lo + 1::f, :])
  return 0.5 * (rows[:, :, lo::f] + rows[:, :, lo + 1::f])


NOISE_PARAMS = ('poisson_rate_multiplier', 'jitter_rate',
                'salt_and_pepper_amount', 'contrast_gamma',
                'uniform_noise_scale', 'exponential_lambda',
                'gaussian_variance')


def observe(scene: dict, draws: dict, *, num_cols: int, capacity: int,
            render_size: int, feature_size: int,
            precision: str = 'float32') -> torch.Tensor:
  """The policy's image (B, F, F) of each recorded scene: the atoms in the
  field of view shifted by -drift, splat, noise, CLAHE, downsample."""
  dev = scene['offset'].device
  canon = torch.from_numpy(graphene_positions(num_cols)).to(dev)
  ll = scene['lower_left'] - scene['drift']
  ur = scene['upper_right'] - scene['drift']
  micro, z = atoms_in_view(canon, scene['offset'], scene['theta'],
                           scene['si_index'], ll, ur, capacity)
  clean = splat(micro, z, ur[:, 0] - ll[:, 0], ur[:, 1] - ll[:, 1],
                scene['intensity_exponent'], scene['blur_amount'],
                render_size, precision)
  noisy = noise_chain(clean, scene, draws, precision)
  return downsample(clahe(noisy), feature_size)
