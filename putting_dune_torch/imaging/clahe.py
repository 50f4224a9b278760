"""Contrast-limited adaptive histogram equalization (CLAHE).

Port of putting_dune_tpu/imaging/clahe.py `equalize_adapthist` and
`equalize_adapthist_padded`: a grid x grid tile mesh, nbins-bin tile
histograms clipped at clip_limit * tile pixels with the excess spread
uniformly, and a bilinear blend of the four surrounding tiles' cdfs per
pixel.

Routing follows the JAX package's size classes and depends on the shape
alone: frames whose tiles have at most 512 pixels (128^2 and 64^2 at grid
8) take the one-launch kernel `clahe_small`; larger tiles take
`clahe_hist_lut` + `clahe_remap`. CPU tensors go through the same
wrappers, which then run their plain twins. `backend='interp'` takes the
non-fused route instead: the frame is cut into edge-padded dual blocks and
remapped by `clahe_interpolate` (ops/clahe_interp.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from putting_dune_torch.ops import clahe_fused
from putting_dune_torch.ops import clahe_interp

CLAHE_BACKENDS = ('auto', 'interp')


def clahe_route(height: int, width: int, grid_size: int) -> str:
  """'small' or 'split': the kernel route of an (H, W) frame."""
  tile_pixels = (height // grid_size) * (width // grid_size)
  return 'small' if tile_pixels <= clahe_fused.SMALL_TILE_PIXELS else 'split'


def dual_block_inputs(
    image: torch.Tensor, clip_limit: float = 0.01, grid_size: int = 8,
    nbins: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The operands of `clahe_interpolate` for a (B, H, W) frame batch.

  Returns (blocks, luts, wgt): the pixel bins cut into edge-padded,
  half-tile-offset dual blocks, (B, K, P) int32 with K = (g+1)^2 and
  P = th * tw; the four corner tile mappings of each dual block,
  (B, K, V, 4), tiles (clip(i-1), clip(i)) x (clip(j-1), clip(j)) of the
  mappings `clahe_hist_lut` computes; and the in-block bilinear weights
  (P, 4), fy = (row_in_block + 0.5) / th and fx likewise.
  """
  b, h, w = image.shape
  g = grid_size
  if h % g or w % g:
    raise ValueError(f'Image dims ({h}, {w}) must be divisible by {g}.')
  th, tw = h // g, w // g
  dev = image.device
  _, mapping = clahe_fused.clahe_hist_lut(image, g, clip_limit, nbins)

  bins = torch.clamp((image * nbins).to(torch.int32), 0, nbins - 1)
  # Edge padding by half a tile before and the rest of a tile after, as
  # index clamps (F.pad has no integer edge mode).
  rows = torch.clamp(torch.arange(-(th // 2), h + th - th // 2, device=dev),
                     0, h - 1)
  cols = torch.clamp(torch.arange(-(tw // 2), w + tw - tw // 2, device=dev),
                     0, w - 1)
  padded = bins[:, rows][:, :, cols]  # (B, (g+1) th, (g+1) tw)
  blocks = (
      padded.reshape(b, g + 1, th, g + 1, tw)
      .permute(0, 1, 3, 2, 4)
      .reshape(b, (g + 1) * (g + 1), th * tw)
      .contiguous()
  )

  fy = ((torch.arange(th, dtype=torch.float32, device=dev) + 0.5) / th
        )[:, None]
  fx = ((torch.arange(tw, dtype=torch.float32, device=dev) + 0.5) / tw
        )[None, :]
  wgt = torch.stack(
      [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], dim=-1
  ).reshape(th * tw, 4).contiguous()

  lo = torch.clamp(torch.arange(g + 1, device=dev) - 1, min=0)
  hi = torch.clamp(torch.arange(g + 1, device=dev), max=g - 1)
  luts = torch.stack(
      [
          mapping[:, lo][:, :, lo],
          mapping[:, lo][:, :, hi],
          mapping[:, hi][:, :, lo],
          mapping[:, hi][:, :, hi],
      ],
      dim=-1,
  ).reshape(b, (g + 1) * (g + 1), nbins, 4).contiguous()
  return blocks, luts, wgt


def _interp_route(
    image: torch.Tensor, clip_limit: float, grid_size: int, nbins: int
) -> torch.Tensor:
  """CLAHE through dual blocks and `clahe_interpolate`: block the frame,
  run the kernel, un-block and crop the half-tile padding."""
  b, h, w = image.shape
  g = grid_size
  blocks, luts, wgt = dual_block_inputs(image, clip_limit, g, nbins)
  th, tw = h // g, w // g
  out_blocks = clahe_interp.clahe_interpolate(blocks, luts, wgt)
  out_padded = (
      out_blocks.reshape(b, g + 1, g + 1, th, tw)
      .permute(0, 1, 3, 2, 4)
      .reshape(b, (g + 1) * th, (g + 1) * tw)
  )
  return out_padded[:, th // 2:th // 2 + h, tw // 2:tw // 2 + w].contiguous()


def equalize_adapthist(
    image: torch.Tensor,
    clip_limit: float = 0.01,
    grid_size: int = 8,
    nbins: int = 256,
    backend: str = 'auto',
) -> torch.Tensor:
  """Applies CLAHE to a (B, H, W) float32 batch in [0, 1].

  H and W must be divisible by grid_size. Returns (B, H, W) in [0, 1].

  backend: 'auto' routes by tile size to the fused kernels (the JAX
  package's 'auto' / 'pallas_fused'); 'interp' is the non-fused route
  through dual blocks and `clahe_interpolate` (the JAX package's
  backend='pallas'): the same function of the frame, kept as the baseline
  the fused kernels are measured against.
  """
  if backend not in CLAHE_BACKENDS:
    raise ValueError(
        f'backend must be one of {CLAHE_BACKENDS}, got {backend!r}.')
  if image.dim() != 3:
    raise ValueError(f'image: expected (B, H, W), got {tuple(image.shape)}.')
  _, h, w = image.shape
  if backend == 'interp':
    return _interp_route(image, clip_limit, grid_size, nbins)
  if clahe_route(h, w, grid_size) == 'small':
    return clahe_fused.clahe_small(image, clip_limit, grid_size, nbins)
  _, mapping = clahe_fused.clahe_hist_lut(image, grid_size, clip_limit, nbins)
  return clahe_fused.clahe_remap(image, mapping)


def equalize_adapthist_padded(
    image: torch.Tensor,
    clip_limit: float = 0.01,
    grid_size: int = 8,
    nbins: int = 256,
    backend: str = 'auto',
) -> torch.Tensor:
  """CLAHE for frames of any spatial size (real-microscope inputs).

  Pads symmetrically to a multiple of 2 * grid_size (reflect; edge for
  frames no larger than that multiple), equalizes, and crops back, as
  skimage's equalize_adapthist does. `backend` as in equalize_adapthist.
  """
  _, h, w = image.shape
  mult = 2 * grid_size
  ph = (-h) % mult
  pw = (-w) % mult
  if not ph and not pw:
    return equalize_adapthist(image, clip_limit, grid_size, nbins, backend)
  top, left = ph // 2, pw // 2
  mode = 'reflect' if min(h, w) > mult else 'replicate'
  padded = F.pad(
      image[:, None], (left, pw - left, top, ph - top), mode=mode
  )[:, 0].contiguous()
  out = equalize_adapthist(padded, clip_limit, grid_size, nbins, backend)
  return out[:, top:top + h, left:left + w]
