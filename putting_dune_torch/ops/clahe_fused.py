"""CLAHE: the three CUDA kernels' wrappers and their plain twins.

Port of putting_dune_tpu/ops/clahe_fused_pallas.py. The JAX package has
three routes there (`clahe_fused` for tiles of at most 512 pixels,
`clahe_fused_large` and `clahe_fused_large_natural` for larger ones, each
with several histogram kernels); the port has

  * `clahe_hist_lut` (csrc/clahe_hist_lut.cu): per (image, tile) the
    nbins-bin histogram, the one-pass clip at max(clip * npx, 1) with the
    excess spread uniformly, and the normalized cdf `mapping`;
  * `clahe_remap` (csrc/clahe_remap.cu): per pixel, the bilinear blend of
    the four surrounding tiles' mappings over the half-tile-offset dual
    blocks, edge-clamped at the border -- the math of the JAX package's
    CPU path (putting_dune_tpu/imaging/clahe.py), in f32;
  * `clahe_small` (csrc/clahe_small.cu): both steps in one launch, one
    block per image, histograms and mappings held in shared memory, for
    frames whose tiles have at most `SMALL_TILE_PIXELS` pixels.

Every kernel takes `nbins` (2..`MAX_NBINS`) and the grid at run time.
Which route a frame takes is decided by its shape alone
(imaging/clahe.py). On CPU tensors each wrapper runs its twin
(`hist_lut_reference`, `remap_reference`, `clahe_reference`): histograms
by bincount and LUT reads by gather, never a (pixels x bins) one-hot.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from putting_dune_torch.ops import _build

NBINS = 256
MAX_NBINS = 1024
# Tiles up to this many pixels take the one-launch kernel (the JAX
# package's `fused_small` rule).
SMALL_TILE_PIXELS = 512
# Dynamic shared memory one block may ask for on sm_90.
MAX_SHARED_BYTES = 232448


def _bins(image: torch.Tensor, nbins: int) -> torch.Tensor:
  return torch.clamp((image * nbins).to(torch.int64), 0, nbins - 1)


def clip_limit_count(clip_limit: float, npx: int) -> float:
  """max(clip_limit * npx, 1) rounded to f32, as the JAX package does."""
  return float(np.float32(max(clip_limit * npx, 1.0)))


def _check_image(image: torch.Tensor, grid_size: int) -> None:
  _build.check_tensor(image, 'image', torch.float32, 3)
  _, h, w = image.shape
  if h % grid_size or w % grid_size:
    raise ValueError(
        f'Image dims ({h}, {w}) must be divisible by {grid_size}.'
    )


# --- plain twins ----------------------------------------------------------------


def hist_lut_reference(
    image: torch.Tensor, grid_size: int = 8, clip_limit: float = 0.01,
    nbins: int = NBINS,
) -> tuple[torch.Tensor, torch.Tensor]:
  """(hist int32, mapping f32), each (B, g, g, nbins)."""
  b, h, w = image.shape
  g = grid_size
  th, tw = h // g, w // g
  bins = _bins(image, nbins)
  tile_y = torch.arange(h, device=image.device) // th
  tile_x = torch.arange(w, device=image.device) // tw
  tile = tile_y[:, None] * g + tile_x[None, :]  # (H, W)
  flat = (
      (torch.arange(b, device=image.device)[:, None, None] * (g * g) + tile)
      * nbins + bins
  )
  hist = torch.bincount(flat.reshape(-1), minlength=b * g * g * nbins)
  hist = hist.reshape(b, g, g, nbins).to(torch.int32)

  clim = clip_limit_count(clip_limit, th * tw)
  hf = hist.to(torch.float32)
  excess = torch.sum(torch.clamp(hf - clim, min=0.0), dim=-1, keepdim=True)
  hf = torch.clamp(hf, max=clim) + excess / nbins
  cdf = torch.cumsum(hf, dim=-1)
  return hist, cdf / cdf[..., -1:]


def remap_reference(image: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
  """Bilinear four-LUT remap of (B, H, W) through (B, g, g, V) mappings."""
  b, h, w = image.shape
  g, nbins = mapping.shape[1], mapping.shape[-1]
  th, tw = h // g, w // g
  dev = image.device

  def axis(n, t):
    pos = torch.arange(n, device=dev) + t // 2
    blk = pos // t
    frac = ((pos - blk * t).to(torch.float32) + 0.5) / t
    lo = torch.clamp(blk - 1, 0, g - 1)
    hi = torch.clamp(blk, max=g - 1)
    return lo, hi, frac

  i0, i1, fy = axis(h, th)
  j0, j1, fx = axis(w, tw)
  fy, fx = fy[:, None], fx[None, :]
  bins = _bins(image, nbins)
  lut = mapping.reshape(b, g * g * nbins)

  def read(i, j):
    idx = (i[:, None] * g + j[None, :]) * nbins + bins  # (B, H, W)
    return torch.gather(lut, 1, idx.reshape(b, -1)).reshape(b, h, w)

  w00 = (1.0 - fy) * (1.0 - fx)
  w01 = (1.0 - fy) * fx
  w10 = fy * (1.0 - fx)
  w11 = fy * fx
  return (read(i0, j0) * w00 + read(i0, j1) * w01 + read(i1, j0) * w10
          + read(i1, j1) * w11)


def clahe_reference(
    image: torch.Tensor, clip_limit: float = 0.01, grid_size: int = 8,
    nbins: int = NBINS,
) -> torch.Tensor:
  """The whole CLAHE in plain PyTorch."""
  _, mapping = hist_lut_reference(image, grid_size, clip_limit, nbins)
  return remap_reference(image, mapping)


# --- kernel wrappers ------------------------------------------------------------


def _cuda_only(name: str, image: torch.Tensor, nbins: int) -> None:
  if not image.is_cuda:
    raise ValueError(f'{name}: unsupported device {image.device}.')
  if not 2 <= nbins <= MAX_NBINS:
    raise ValueError(
        f'{name}: nbins must be in [2, {MAX_NBINS}], got {nbins}.')


def clahe_hist_lut(
    image: torch.Tensor, grid_size: int = 8, clip_limit: float = 0.01,
    nbins: int = NBINS,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Tile histograms (int32) and clipped-cdf mappings (f32), (B, g, g, V)."""
  _check_image(image, grid_size)
  if image.device.type == 'cpu':
    return hist_lut_reference(image, grid_size, clip_limit, nbins)
  _cuda_only('clahe_hist_lut', image, nbins)
  b, h, w = image.shape
  g = grid_size
  hist = torch.empty((b, g, g, nbins), dtype=torch.int32, device=image.device)
  mapping = torch.empty((b, g, g, nbins), device=image.device)
  fn = _build.load('clahe_hist_lut').clahe_hist_lut_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
      ctypes.c_float, ctypes.c_void_p
  ]
  status = fn(
      _build.ptr(image), _build.ptr(hist), _build.ptr(mapping), b, h, w, g,
      nbins, clip_limit_count(clip_limit, (h // g) * (w // g)),
      _build.stream_ptr(image.device),
  )
  _build.check_status('clahe_hist_lut', status)
  _build.count_launch('clahe_hist_lut')
  return hist, mapping


def clahe_remap(image: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
  """Remaps (B, H, W) through (B, g, g, V) tile mappings."""
  _build.check_tensor(mapping, 'mapping', torch.float32, 4)
  b, g = mapping.shape[0], mapping.shape[1]
  _check_image(image, g)
  if mapping.shape[2] != g or b != image.shape[0]:
    raise ValueError(f'mapping: bad shape {tuple(mapping.shape)}.')
  if image.device.type == 'cpu':
    return remap_reference(image, mapping)
  _cuda_only('clahe_remap', image, mapping.shape[-1])
  if mapping.device != image.device:
    raise ValueError('clahe_remap: image and mapping on different devices.')
  _, h, w = image.shape
  out = torch.empty_like(image)
  fn = _build.load('clahe_remap').clahe_remap_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
  status = fn(
      _build.ptr(image), _build.ptr(mapping), _build.ptr(out), b, h, w, g,
      mapping.shape[-1], _build.stream_ptr(image.device),
  )
  _build.check_status('clahe_remap', status)
  _build.count_launch('clahe_remap')
  return out


def clahe_small(
    image: torch.Tensor, clip_limit: float = 0.01, grid_size: int = 8,
    nbins: int = NBINS, *, return_hist: bool = False,
):
  """The whole CLAHE of (B, H, W) frames with small tiles in one launch.

  Equal to `clahe_remap(image, clahe_hist_lut(image, ...)[1])`. Tiles may
  have at most `SMALL_TILE_PIXELS` pixels. With `return_hist` also
  returns the (B, g, g, nbins) int32 tile histograms.
  """
  _check_image(image, grid_size)
  b, h, w = image.shape
  g = grid_size
  npx = (h // g) * (w // g)
  if npx > SMALL_TILE_PIXELS:
    raise ValueError(
        f'clahe_small: tiles of {npx} pixels exceed {SMALL_TILE_PIXELS}.')
  if image.device.type == 'cpu':
    hist, mapping = hist_lut_reference(image, g, clip_limit, nbins)
    out = remap_reference(image, mapping)
    return (out, hist) if return_hist else out
  _cuda_only('clahe_small', image, nbins)
  lib = _build.load('clahe_small')
  lib.clahe_small_shared_bytes.restype = ctypes.c_int
  lib.clahe_small_shared_bytes.argtypes = [ctypes.c_int] * 2
  shared = lib.clahe_small_shared_bytes(g, nbins)
  if shared > MAX_SHARED_BYTES:
    raise ValueError(
        f'clahe_small: grid {g} x {nbins} bins needs {shared} bytes of '
        f'shared memory, above the {MAX_SHARED_BYTES} a block may have.')
  out = torch.empty_like(image)
  hist = (torch.empty((b, g, g, nbins), dtype=torch.int32,
                      device=image.device) if return_hist else None)
  fn = lib.clahe_small_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
      ctypes.c_float, ctypes.c_void_p
  ]
  status = fn(
      _build.ptr(image), _build.ptr(out), _build.ptr(hist), b, h, w, g,
      nbins, clip_limit_count(clip_limit, npx),
      _build.stream_ptr(image.device),
  )
  _build.check_status('clahe_small', status)
  _build.count_launch('clahe_small')
  return (out, hist) if return_hist else out
