"""Contrast-limited adaptive histogram equalization (CLAHE).

Port of putting_dune_tpu/imaging/clahe.py `equalize_adapthist`: a grid x
grid tile mesh, 256-bin tile histograms clipped at clip_limit * tile
pixels with the excess spread uniformly, and a bilinear blend of the four
surrounding tiles' cdfs per pixel. CUDA tensors go through the two
kernels of ops/clahe_fused.py; CPU tensors through their plain twins.
Works for any tile size that divides the frame.
"""

from __future__ import annotations

import torch

from putting_dune_torch.ops import clahe_fused


def equalize_adapthist(
    image: torch.Tensor,
    clip_limit: float = 0.01,
    grid_size: int = 8,
    nbins: int = 256,
) -> torch.Tensor:
  """Applies CLAHE to a (B, H, W) float32 batch in [0, 1].

  H and W must be divisible by grid_size. Returns (B, H, W) in [0, 1].
  """
  _, mapping = clahe_fused.clahe_hist_lut(image, grid_size, clip_limit, nbins)
  return clahe_fused.clahe_remap(image, mapping)
