"""Fused Gaussian splat: the CUDA kernel's wrapper and its plain twin.

Port of putting_dune_tpu/ops/splat_pallas.py `splat_render`. Bin centres
are integers and sigma is one scalar per image, so every atom's 1-D kernel
row is a shifted copy of one truncated Gaussian profile of length 2S:

    prof[j]      = exp(-0.5 ((j - S) / sigma)^2)  for |j - S| <= radius,
                   radius = floor(4 sigma + 0.5), else 0
    image[y, x]  = sum_k w_k * profy[y - byf_k + S] * profx[x - bx_k + S]
    out          = image / max(max(image), 1e-20)

with the y bins flipped at bin level (byf = S-1-by: row 0 is the image
top). `splat_render` launches csrc/splat_render.cu on CUDA tensors and
runs `splat_render_reference` on CPU tensors: the plain splat, the two
(B, K, S) factor tensors and one f32 `torch.bmm` (the JAX package's
einsum route, and imaging/render.py's backend='bmm' on any device).
`splat_render_atom_order` sums the atoms one by one, as the kernel does:
the oracle its frames are held to bit for bit, on the card and in the
tests.

Numerics: the factors stay float32 and the sum is accumulated in float32,
one fused multiply-add an atom in atom order: the arithmetic of an f32
GEMM's FFMA chain, so on an H100 the kernel's frames are bit-equal to
`splat_render_reference` at the env's shapes. The TPU kernel casts its
factors to bfloat16 for the matrix unit; that trade is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from putting_dune_torch.ops import _build

MAX_IMAGE_SIZE = 2048
MAX_BATCH = 65535


def _profile(sigma: torch.Tensor, size: int) -> torch.Tensor:
  """(B, 2S) truncated Gaussian profiles, prof[:, j] centred on j = S."""
  j = torch.arange(2 * size, dtype=torch.float32, device=sigma.device)
  d = (j - float(size))[None, :]
  s = sigma[:, None]
  radius = torch.floor(4.0 * s + 0.5)
  kern = torch.exp(-0.5 * torch.square(d / s))
  return torch.where(torch.abs(d) <= radius, kern, torch.zeros_like(kern))


def _shifted_rows(prof: torch.Tensor, shift: torch.Tensor, size: int
                  ) -> torch.Tensor:
  """rows[b, k, c] = prof[b, c - shift[b, k] + S] for c in [0, S)."""
  cols = torch.arange(size, device=prof.device)
  idx = cols[None, None, :] - shift[..., None] + size  # (B, K, S)
  b, k = shift.shape
  return torch.gather(
      prof[:, None, :].expand(b, k, 2 * size), 2, idx)


def _axis_kernels(
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


def splat_render_reference(
    bx: torch.Tensor, by: torch.Tensor, weights: torch.Tensor,
    sigma_x: torch.Tensor, sigma_y: torch.Tensor, *, image_size: int,
) -> torch.Tensor:
  """The plain splat: one exp per (atom, pixel) in two (B, K, S) factor
  tensors, then (Gy * w)^T @ Gx by `torch.bmm`, flipped so that row 0 is
  the image top."""
  s = image_size
  gx = _axis_kernels(torch.clamp(bx, 0, s - 1), sigma_x, s)  # (B, K, S)
  gy = (_axis_kernels(torch.clamp(by, 0, s - 1), sigma_y, s)
        * weights[..., None])
  image = torch.bmm(gy.transpose(1, 2), gx)  # (B, S_y, S_x)
  image = torch.flip(image, dims=(-2,))
  peak = torch.amax(image, dim=(-2, -1), keepdim=True)
  return image / torch.clamp(peak, min=1e-20)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
  """a * b + c of float32 tensors rounded once to float32, as `fmaf`.

  The product is exact in float64 and TwoSum gives the float64 sum's
  error; rounding that sum to float32 is then correct except where it lies
  exactly halfway between two floats, where the error's sign decides.
  """
  p = a.double() * b.double()
  c = c.double()
  s = p + c
  z = s - p
  err = (p - (s - z)) + (c - z)
  r = s.float()
  toward = torch.where(r.double() > s, -torch.inf, torch.inf)
  other = torch.nextafter(r, toward.float())
  tie = (r.double() + other.double()) * 0.5 == s
  pick_other = tie & (err != 0) & ((err > 0) == (other > r))
  return torch.where(pick_other, other, r)


def splat_render_atom_order(
    bx: torch.Tensor, by: torch.Tensor, weights: torch.Tensor,
    sigma_x: torch.Tensor, sigma_y: torch.Tensor, *, image_size: int,
) -> torch.Tensor:
  """The frame as `acc = fma(w_k * gy_k, gx_k, acc)`, atom by atom, then
  the peak and the divide: the kernel's expression in the kernel's order
  (atoms that miss a pixel add +0, which changes no bit)."""
  s = image_size
  ix = torch.clamp(bx.to(torch.int64), 0, s - 1)
  iyf = (s - 1) - torch.clamp(by.to(torch.int64), 0, s - 1)
  gx = _shifted_rows(_profile(sigma_x, s), ix, s)  # (B, K, S)
  gy = _shifted_rows(_profile(sigma_y, s), iyf, s)
  acc = torch.zeros((bx.shape[0], s, s), device=bx.device)
  for k in range(bx.shape[1]):
    wy = weights[:, k, None] * gy[:, k]  # (B, S_y)
    acc = fma32(wy[:, :, None], gx[:, k, None, :], acc)
  peak = torch.amax(acc, dim=(-2, -1), keepdim=True)
  return acc / torch.clamp(peak, min=1e-20)


def splat_render(
    bx: torch.Tensor, by: torch.Tensor, weights: torch.Tensor,
    sigma_x: torch.Tensor, sigma_y: torch.Tensor, *, image_size: int,
) -> torch.Tensor:
  """Max-normalized clean frames (B, S, S) f32, row 0 at the image top.

  Args:
    bx, by: (B, K) f32 integer-valued bins in [0, S) (clamped to it).
    weights: (B, K) f32 non-negative atom weights, 0 for masked atoms.
    sigma_x, sigma_y: (B,) f32 Gaussian widths in pixels.
    image_size: S.
  """
  s = int(image_size)
  for name, t in (('bx', bx), ('by', by), ('weights', weights)):
    _build.check_tensor(t, name, torch.float32, 2)
  for name, t in (('sigma_x', sigma_x), ('sigma_y', sigma_y)):
    _build.check_tensor(t, name, torch.float32, 1)
  b, k = bx.shape
  if by.shape != bx.shape or weights.shape != bx.shape:
    raise ValueError('splat_render: bx, by and weights must share a shape.')
  if sigma_x.shape != (b,) or sigma_y.shape != (b,):
    raise ValueError('splat_render: sigmas must have shape (B,).')
  if not 1 <= s <= MAX_IMAGE_SIZE:
    raise ValueError(
        f'splat_render: image_size must be in [1, {MAX_IMAGE_SIZE}].')
  tensors = (bx, by, weights, sigma_x, sigma_y)
  if any(t.device != bx.device for t in tensors):
    raise ValueError('splat_render: tensors on different devices.')
  if bx.device.type == 'cpu':
    return splat_render_reference(
        bx, by, weights, sigma_x, sigma_y, image_size=s)
  if not bx.is_cuda:
    raise ValueError(f'splat_render: unsupported device {bx.device}.')
  if not 1 <= b <= MAX_BATCH:
    raise ValueError(f'splat_render: batch must be in [1, {MAX_BATCH}].')
  out = torch.empty((b, s, s), dtype=torch.float32, device=bx.device)
  fn = _build.function('splat_render', 'splat_render_launch',
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
  status = fn(
      _build.ptr(bx), _build.ptr(by), _build.ptr(weights),
      _build.ptr(sigma_x), _build.ptr(sigma_y), _build.ptr(out), b, k, s,
      _build.stream_ptr(bx.device),
  )
  _build.check_status('splat_render', status)
  _build.count_launch('splat_render')
  return out
