"""STEM image rendering (port of putting_dune_tpu/imaging/render.py).

The clean frame is a separable Gaussian splat of the atoms in view:

    image[y, x] = sum_k w_k * K(y - bin_y(k)) * K(x - bin_x(k))

which is one batched matrix product per frame, (Gy * w)^T @ Gx, left to
`torch.bmm` as the JAX package leaves it to an XLA einsum; with
`backend='fused'` the frame comes from the one-kernel splat of
ops/splat.py instead. The noisy pipeline is splat -> fused noise chain
(ops/noise_fused.py) -> CLAHE (imaging/clahe.py). `render_label_mask`
paints the per-pixel class labels the atom detector is trained on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from putting_dune_torch import geometry
from putting_dune_torch import structures
from putting_dune_torch.imaging import clahe as clahe_lib
from putting_dune_torch.imaging import noise as noise_lib
from putting_dune_torch.ops import noise_fused
from putting_dune_torch.ops import splat as splat_lib

SPLAT_BACKENDS = ('auto', 'fused')
NOISE_BACKENDS = ('fused', 'stages')


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
    backend: str = 'auto',
) -> torch.Tensor:
  """Max-normalized clean STEM frames, (B, S, S) float32; row 0 is the
  top of the image.

  backend: 'auto' is the batched matrix product below (the JAX package's
  'auto' and 'xla'); 'fused' is the one-kernel splat of ops/splat.py (the
  JAX package's backend='pallas'): no (B, K, S) factor tensors, exp() per
  profile entry instead of per (atom, pixel).
  """
  if backend not in SPLAT_BACKENDS:
    raise ValueError(
        f'backend must be one of {SPLAT_BACKENDS}, got {backend!r}.')
  s = image_size
  bx, by, weights, sigma_x, sigma_y = _splat_inputs(
      window, fov, intensity_exponent, s, blur_amount
  )
  if backend == 'fused':
    return splat_lib.splat_render(
        bx.contiguous(), by.contiguous(), weights.contiguous(),
        sigma_x.contiguous(), sigma_y.contiguous(), image_size=s)
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
    noise_backend: str = 'fused',
) -> torch.Tensor:
  """Full noisy STEM frames: splat (+blur) -> noise -> CLAHE.

  noise_backend: 'fused' (the default) runs the seven noise stages as the
  one `noise_chain` kernel (the JAX package's 'pallas_fused'); 'stages'
  runs them one operator at a time (imaging/noise.py, the JAX package's
  'xla' chain). The two draw different numbers from `gen`; their laws are
  the same.
  """
  if noise_backend not in NOISE_BACKENDS:
    raise ValueError(
        f'noise_backend must be one of {NOISE_BACKENDS}, got '
        f'{noise_backend!r}.')
  image = render_clean_image(
      window, fov, params.intensity_exponent, image_size=image_size,
      blur_amount=params.blur_amount,
  )
  if noise_backend == 'stages':
    image = noise_lib.apply_stages(gen, image, params)
  else:
    packed = noise_fused.pack_params(params, image.shape[0])
    image = noise_fused.noise_chain(image, packed, gen=gen)
  if apply_clahe:
    image = clahe_lib.equalize_adapthist(image, clip_limit=0.01)
  return image


# Elements of the (B, k, S, S) disk test `render_label_mask` holds at once.
_LABEL_CHUNK_ELEMENTS = 2**27


def geometry_microscope_to_material_grid(
    lin: torch.Tensor, fov: structures.FieldOfView
) -> torch.Tensor:
  """Maps a [0,1] linspace to material x and y coordinate rows, (2, B, S)."""
  xs = (
      lin[None, :] * (fov.upper_right[:, :1] - fov.lower_left[:, :1])
      + fov.lower_left[:, :1]
  )
  ys = (
      lin[None, :] * (fov.upper_right[:, 1:] - fov.lower_left[:, 1:])
      + fov.lower_left[:, 1:]
  )
  return torch.stack([xs, ys])


def render_label_mask(
    window: structures.AtomWindow,
    fov: structures.FieldOfView,
    *,
    intensity_exponent: torch.Tensor | float = 1.7,
    image_size: int = 512,
) -> torch.Tensor:
  """Semantic label image: pixel = atomic number of the covering atom.

  Each atom stamps a disk; where disks overlap the higher atomic number
  wins. As in the JAX package (and the reference it copies) the SQUARED
  pixel distance is compared against the UNSQUARED radius value
  (Z/6)^exponent * 0.1, so the effective disk radius is its square root.
  Returns (B, S, S) int32 with 0 = background; row 0 is the top.

  The (B, K, S, S) disk test is never held whole: the atoms are reduced
  in chunks of K (3.4 GB as booleans at B 100, K 512, S 256 otherwise).
  """
  s = image_size
  positions = window.positions
  b, k = positions.shape[:2]
  device = positions.device
  exponent = torch.as_tensor(
      intensity_exponent, dtype=torch.float32, device=device
  ).expand(b)

  lin = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
  xs, ys = geometry_microscope_to_material_grid(lin, fov)  # (B, S) each
  pos_material = geometry.microscope_to_material(
      positions, fov.lower_left[:, None, :], fov.upper_right[:, None, :]
  )  # (B, K, 2)

  z = window.atomic_numbers.to(torch.float32)
  radius = torch.pow(z / 6.0, exponent[:, None]) * 0.1  # (B, K)
  radius2 = torch.where(window.mask, radius, torch.full_like(radius, -1.0))

  dx2 = torch.square(xs[:, None, :] - pos_material[..., 0][..., None])
  dy2 = torch.square(ys[:, None, :] - pos_material[..., 1][..., None])
  numbers = window.atomic_numbers.to(torch.int16)
  labels = torch.zeros((b, s, s), dtype=torch.int16, device=device)
  chunk = max(1, _LABEL_CHUNK_ELEMENTS // max(b * s * s, 1))
  for k0 in range(0, k, chunk):
    sl = slice(k0, k0 + chunk)
    inside = (
        dx2[:, sl, None, :] + dy2[:, sl, :, None]
    ) < radius2[:, sl, None, None]
    stamped = torch.amax(inside * numbers[:, sl, None, None], dim=1)
    labels = torch.maximum(labels, stamped)
  return torch.flip(labels, dims=(-2,)).to(torch.int32)


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
