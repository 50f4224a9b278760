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
wrappers, which then run their plain twins.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from putting_dune_torch.ops import clahe_fused


def clahe_route(height: int, width: int, grid_size: int) -> str:
  """'small' or 'split': the kernel route of an (H, W) frame."""
  tile_pixels = (height // grid_size) * (width // grid_size)
  return 'small' if tile_pixels <= clahe_fused.SMALL_TILE_PIXELS else 'split'


def equalize_adapthist(
    image: torch.Tensor,
    clip_limit: float = 0.01,
    grid_size: int = 8,
    nbins: int = 256,
) -> torch.Tensor:
  """Applies CLAHE to a (B, H, W) float32 batch in [0, 1].

  H and W must be divisible by grid_size. Returns (B, H, W) in [0, 1].
  """
  if image.dim() != 3:
    raise ValueError(f'image: expected (B, H, W), got {tuple(image.shape)}.')
  _, h, w = image.shape
  if clahe_route(h, w, grid_size) == 'small':
    return clahe_fused.clahe_small(image, clip_limit, grid_size, nbins)
  _, mapping = clahe_fused.clahe_hist_lut(image, grid_size, clip_limit, nbins)
  return clahe_fused.clahe_remap(image, mapping)


def equalize_adapthist_padded(
    image: torch.Tensor,
    clip_limit: float = 0.01,
    grid_size: int = 8,
    nbins: int = 256,
) -> torch.Tensor:
  """CLAHE for frames of any spatial size (real-microscope inputs).

  Pads symmetrically to a multiple of 2 * grid_size (reflect; edge for
  frames no larger than that multiple), equalizes, and crops back, as
  skimage's equalize_adapthist does.
  """
  _, h, w = image.shape
  mult = 2 * grid_size
  ph = (-h) % mult
  pw = (-w) % mult
  if not ph and not pw:
    return equalize_adapthist(image, clip_limit, grid_size, nbins)
  top, left = ph // 2, pw // 2
  mode = 'reflect' if min(h, w) > mult else 'replicate'
  padded = F.pad(
      image[:, None], (left, pw - left, top, ph - top), mode=mode
  )[:, 0].contiguous()
  out = equalize_adapthist(padded, clip_limit, grid_size, nbins)
  return out[:, top:top + h, left:left + w]
