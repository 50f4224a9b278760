"""STEM image rendering (port of putting_dune_tpu/imaging/render.py).

The clean frame is a separable Gaussian splat of the atoms in view:

    image[y, x] = sum_k w_k * K(y - bin_y(k)) * K(x - bin_x(k))

which is one batched matrix product per frame, (Gy * w)^T @ Gx, left to
`torch.bmm` as the JAX package leaves it to an XLA einsum. The noisy
pipeline is splat -> fused noise chain (ops/noise_fused.py) -> CLAHE
(imaging/clahe.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from putting_dune_torch import structures
from putting_dune_torch.imaging import clahe as clahe_lib
from putting_dune_torch.ops import noise_fused


def _splat_axis_kernels(
    bin_centers: torch.Tensor, sigma: torch.Tensor, image_size: int
) -> torch.Tensor:
  """Truncated 1D Gaussian kernels per atom: (B, K, image_size)."""
  coords = torch.arange(image_size, dtype=torch.float32,
                        device=bin_centers.device)
  d = coords - bin_centers[..., None]
  s = sigma[:, None, None]
  radius = torch.floor(4.0 * s + 0.5)
  kern = torch.exp(-0.5 * torch.square(d / s))
  return torch.where(torch.abs(d) <= radius, kern, torch.zeros_like(kern))


def _splat_inputs(window, fov, intensity_exponent, s, blur_amount):
  """Bins (floor(p * S), clipped to the last bin), weights Z**exponent and
  per-image sigmas S / (2.15 * fov extent), blur folded in quadrature."""
  positions = window.positions
  bx = torch.clamp(torch.floor(positions[..., 0] * s), 0, s - 1)
  by = torch.clamp(torch.floor(positions[..., 1] * s), 0, s - 1)
  sigma_x = s / (2.15 * fov.width)
  sigma_y = s / (2.15 * fov.height)
  if blur_amount is not None:
    sigma_x = torch.sqrt(torch.square(sigma_x) + torch.square(blur_amount))
    sigma_y = torch.sqrt(torch.square(sigma_y) + torch.square(blur_amount))
  weights = torch.where(
      window.mask,
      torch.pow(window.atomic_numbers.to(torch.float32),
                intensity_exponent[..., None]),
      torch.zeros((), device=positions.device),
  )
  return bx, by, weights, sigma_x, sigma_y


def render_clean_image(
    window: structures.AtomWindow,
    fov: structures.FieldOfView,
    intensity_exponent: torch.Tensor,
    *,
    image_size: int = 512,
    blur_amount: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Max-normalized clean STEM frames, (B, S, S) float32; row 0 is the
  top of the image."""
  s = image_size
  bx, by, weights, sigma_x, sigma_y = _splat_inputs(
      window, fov, intensity_exponent, s, blur_amount
  )
  gx = _splat_axis_kernels(bx, sigma_x, s)  # (B, K, S)
  gy = _splat_axis_kernels(by, sigma_y, s) * weights[..., None]
  image = torch.bmm(gy.transpose(1, 2), gx)  # (B, S_y, S_x)
  image = torch.flip(image, dims=(-2,))
  peak = torch.amax(image, dim=(-2, -1), keepdim=True)
  return image / torch.clamp(peak, min=1e-20)


def render_stem_image(
    gen: torch.Generator,
    window: structures.AtomWindow,
    fov: structures.FieldOfView,
    params: structures.ImagingParams,
    *,
    image_size: int = 512,
    apply_clahe: bool = True,
) -> torch.Tensor:
  """Full noisy STEM frames: splat (+blur) -> noise chain -> CLAHE."""
  image = render_clean_image(
      window, fov, params.intensity_exponent, image_size=image_size,
      blur_amount=params.blur_amount,
  )
  packed = noise_fused.pack_params(params, image.shape[0])
  image = noise_fused.noise_chain(image, packed, gen=gen)
  if apply_clahe:
    image = clahe_lib.equalize_adapthist(image, clip_limit=0.01)
  return image


def resize_bilinear(image: torch.Tensor, size: int) -> torch.Tensor:
  """Bilinear resize of (B, H, W) frames to (B, size, size).

  Integer downsample factors take a strided path: bilinear sampling at
  factor f reads position f*i + (f-1)/2, an exact source pixel for odd f
  and the mean of two neighbours for even f.
  """
  _, h, w = image.shape
  if h == w and h % size == 0:
    f = h // size
    if f == 1:
      return image
    if f % 2:
      off = (f - 1) // 2
      return image[:, off::f, off::f]
    lo = f // 2 - 1
    rows = 0.5 * (image[:, lo::f, :] + image[:, lo + 1::f, :])
    return 0.5 * (rows[:, :, lo::f] + rows[:, :, lo + 1::f])
  return F.interpolate(
      image[:, None], size=(size, size), mode='bilinear',
      align_corners=False, antialias=False,
  )[:, 0]
