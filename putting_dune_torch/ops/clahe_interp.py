"""CLAHE four-corner LUT interpolation: the CUDA kernel's wrapper and twin.

Port of putting_dune_tpu/ops/clahe_pallas.py `clahe_interpolate`:

    out[b, k, p] = sum_c wgt[p, c] * luts[b, k, bins[b, k, p], c]

over the (g+1)^2 half-tile-offset dual blocks of a frame: every pixel of a
dual block blends the same four tile mappings (`luts[b, k, :, c]`) with
its in-block bilinear weights `wgt[p]`. `clahe_interpolate` launches
csrc/clahe_interp.cu on CUDA tensors and runs
`clahe_interpolate_reference` on CPU tensors. Both sum the four corners
left to right in float32; the LUTs stay float32 (the TPU kernel casts them
to bfloat16 for its one-hot matrix product).
"""

from __future__ import annotations

import ctypes

import torch

from putting_dune_torch.ops import _build

MAX_NBINS = 1024


def clahe_interpolate_reference(
    blocks: torch.Tensor, luts: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
  """Plain PyTorch twin of `clahe_interpolate`."""
  b, k, p = blocks.shape
  v = luts.shape[2]
  idx = torch.clamp(blocks.to(torch.int64), 0, v - 1)
  vals = torch.gather(
      luts, 2, idx[..., None].expand(b, k, p, 4))  # (B, K, P, 4)
  w = weights[None, None]
  return (w[..., 0] * vals[..., 0] + w[..., 1] * vals[..., 1]
          + w[..., 2] * vals[..., 2] + w[..., 3] * vals[..., 3])


def clahe_interpolate(
    blocks: torch.Tensor, luts: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
  """Applies the 4-corner LUT interpolation.

  Args:
    blocks: (B, K, P) int32 dual-block pixel bins in [0, V).
    luts: (B, K, V, 4) float32 corner LUTs.
    weights: (P, 4) float32 bilinear weights.

  Returns:
    (B, K, P) float32 remapped pixels.
  """
  _build.check_tensor(blocks, 'blocks', torch.int32, 3)
  _build.check_tensor(luts, 'luts', torch.float32, 4)
  _build.check_tensor(weights, 'weights', torch.float32, 2)
  b, k, p = blocks.shape
  v = luts.shape[2]
  if luts.shape != (b, k, v, 4):
    raise ValueError(
        f'luts: expected ({b}, {k}, V, 4), got {tuple(luts.shape)}.')
  if weights.shape != (p, 4):
    raise ValueError(
        f'weights: expected ({p}, 4), got {tuple(weights.shape)}.')
  if not 2 <= v <= MAX_NBINS:
    raise ValueError(
        f'clahe_interpolate: nbins must be in [2, {MAX_NBINS}], got {v}.')
  if luts.device != blocks.device or weights.device != blocks.device:
    raise ValueError('clahe_interpolate: tensors on different devices.')
  if blocks.device.type == 'cpu':
    return clahe_interpolate_reference(blocks, luts, weights)
  if not blocks.is_cuda:
    raise ValueError(
        f'clahe_interpolate: unsupported device {blocks.device}.')
  if luts.data_ptr() % 16 or weights.data_ptr() % 16:
    raise ValueError(
        'clahe_interpolate: luts and weights must be 16-byte aligned.')
  out = torch.empty((b, k, p), dtype=torch.float32, device=blocks.device)
  fn = _build.function('clahe_interp', 'clahe_interp_launch',
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
  status = fn(
      _build.ptr(blocks), _build.ptr(luts), _build.ptr(weights),
      _build.ptr(out), b * k, p, v, _build.stream_ptr(blocks.device),
  )
  _build.check_status('clahe_interp', status)
  _build.count_launch('clahe_interp')
  return out
