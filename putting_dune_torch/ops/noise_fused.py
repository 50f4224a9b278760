"""Fused STEM noise chain: the CUDA kernel's wrapper and its plain twin.

Port of putting_dune_tpu/ops/noise_fused_pallas.py. `noise_chain` runs the
seven post-splat noise stages (Poisson shot noise, row jitter, salt &
pepper, gamma contrast, uniform, exponential, Gaussian) in one launch of
csrc/noise_chain.cu on CUDA tensors, with in-kernel Philox draws or, in
the injected mode, with draws read from tensors. On CPU tensors it runs
`noise_chain_reference`, a PyTorch transcription of the JAX package's
`chain_from_uniforms`, which is also the kernel's oracle on the card.

Distributional parity, not bitstream parity, with the JAX package: the
draws come from another generator.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Optional

import torch

from putting_dune_torch import structures
from putting_dune_torch.ops import _build

_POISSON_SMALL_LAMBDA = 4.0
_POISSON_INVERSION_TERMS = 12
_MAX_SHIFT = 127
# Largest Poisson jitter rate for which clipping row shifts at 127 is the
# same law in any statistical sense (P(shift >= 128) < 1e-12).
_MAX_JITTER_RATE = 40.0

# Column order of the per-image parameters in the packed (B, 8) tensor.
PARAM_FIELDS = (
    'poisson_rate_multiplier',
    'jitter_rate',
    'salt_and_pepper_amount',
    'contrast_gamma',
    'uniform_noise_scale',
    'exponential_lambda',
    'gaussian_variance',
)

# Draw fields: (B, H, W) per pixel, (B, H) per row.
PIXEL_DRAWS = ('u_pois', 'z_pois', 'u_sp', 'u_un', 'u_ex', 'z_gauss')
ROW_DRAWS = ('u_row', 'z_row')


def pack_params(params: structures.ImagingParams, batch: int) -> torch.Tensor:
  """Packs per-image noise parameters into the kernel's (B, 8) layout.

  Raises if a jitter_rate exceeds 40: the chain clips row shifts at 127,
  which is the same law only for small Poisson rates.
  """
  jitter = params.jitter_rate
  peak = float(torch.max(jitter)) if jitter.numel() else 0.0
  if peak > _MAX_JITTER_RATE:
    raise ValueError(
        f'jitter_rate {peak} exceeds {_MAX_JITTER_RATE}: the fused noise '
        'chain clips row shifts at 127.'
    )
  cols = [
      torch.broadcast_to(
          getattr(params, name).to(torch.float32), (batch,)
      )
      for name in PARAM_FIELDS
  ]
  cols.append(torch.zeros((batch,), device=jitter.device))
  return torch.stack(cols, dim=1).contiguous()


# --- plain twin ---------------------------------------------------------------


def _poisson_from_draws(u, z, lam):
  """12-term CDF inversion below lambda=4, rounded normal above."""
  lam_safe = torch.clamp(lam, min=1e-20)
  pmf = torch.exp(-lam_safe)
  cdf = pmf
  count = torch.zeros_like(lam)
  for k in range(_POISSON_INVERSION_TERMS):
    count = count + (u > cdf).to(lam.dtype)
    pmf = pmf * lam_safe * (1.0 / (k + 1))
    cdf = cdf + pmf
  large = torch.clamp(
      torch.floor(lam + torch.sqrt(lam_safe) * z + 0.5), min=0.0
  )
  return torch.where(lam < _POISSON_SMALL_LAMBDA, count, large)


def _box_muller(u1, u2):
  r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
  theta = (2.0 * math.pi) * u2
  return r * torch.cos(theta), r * torch.sin(theta)


def _renorm(image):
  peak = torch.amax(image, dim=(-2, -1), keepdim=True)
  return image / torch.clamp(peak, min=1e-20)


def roll_rows(image: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
  """out[b, y, x] = image[b, y, (x - shift[b, y]) mod W], shifts clipped
  to [0, 127]."""
  w = image.shape[-1]
  s = torch.clamp(shifts.to(torch.int64), 0, _MAX_SHIFT)
  lane = torch.arange(w, device=image.device)
  idx = torch.remainder(lane - s[..., None], w)
  return torch.gather(image, -1, idx)


def chain_from_uniforms(
    image: torch.Tensor,
    packed: torch.Tensor,
    draws: Mapping[str, torch.Tensor],
) -> torch.Tensor:
  """The seven-stage chain given all draws, batched.

  Args:
    image: (B, H, W) f32 clean frames in [0, 1].
    packed: (B, 8) f32 parameters (pack_params layout).
    draws: (B, H, W) fields u_pois, z_pois, u_sp, u_un, u_ex, z_gauss and
      (B, H) fields u_row, z_row.

  Returns:
    (B, H, W) f32 noisy frames (pre-CLAHE).
  """
  p = {name: packed[:, j, None, None] for j, name in enumerate(PARAM_FIELDS)}

  lam = image * p['poisson_rate_multiplier']
  image = _renorm(_poisson_from_draws(draws['u_pois'], draws['z_pois'], lam))

  row_lam = torch.ones_like(draws['u_row']) * packed[:, 1, None]
  shifts = _poisson_from_draws(draws['u_row'], draws['z_row'], row_lam)
  image = roll_rows(image, shifts.to(torch.int64))

  u = draws['u_sp']
  a = p['salt_and_pepper_amount']
  image = torch.where(u < a / 2.0, torch.ones_like(image), image)
  image = torch.where((u >= a / 2.0) & (u < a), torch.zeros_like(image), image)

  safe = torch.clamp(image, min=1e-30)
  image = torch.where(
      image <= 0.0, torch.zeros_like(image),
      torch.exp(p['contrast_gamma'] * torch.log(safe)),
  )

  image = _renorm(image + draws['u_un'] * p['uniform_noise_scale'])

  expo = -torch.log(torch.clamp(draws['u_ex'], min=1e-12))
  image = _renorm(image + expo * p['exponential_lambda'])

  sigma = torch.sqrt(p['gaussian_variance'])
  return torch.clamp(image + draws['z_gauss'] * sigma, 0.0, 1.0)


def sample_draws(
    gen: torch.Generator, batch: int, height: int, width: int, device
) -> dict[str, torch.Tensor]:
  """Draws for `chain_from_uniforms` from a torch generator (same laws as
  the kernel's Philox draws: uniforms in (0, 1), Box-Muller normals)."""
  tiny = torch.finfo(torch.float32).tiny

  def u(*shape):
    return torch.rand(shape, generator=gen, device=device).clamp_(min=tiny)

  z_pois, z_gauss = _box_muller(u(batch, height, width),
                                u(batch, height, width))
  u_row = u(batch, height)
  z_row, _ = _box_muller(u(batch, height), u(batch, height))
  return {
      'u_pois': u(batch, height, width),
      'z_pois': z_pois,
      'u_sp': u(batch, height, width),
      'u_un': u(batch, height, width),
      'u_ex': u(batch, height, width),
      'z_gauss': z_gauss,
      'u_row': u_row,
      'z_row': z_row,
  }


def noise_chain_reference(
    image: torch.Tensor,
    packed: torch.Tensor,
    *,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
  """Plain PyTorch twin of the kernel: injected draws, or draws from gen."""
  if draws is None:
    if gen is None:
      raise ValueError('noise_chain_reference needs draws or a generator.')
    b, h, w = image.shape
    draws = sample_draws(gen, b, h, w, image.device)
  return chain_from_uniforms(image, packed, draws)


# --- kernel wrapper -------------------------------------------------------------


def _launch(image, packed, seeds, draws):
  b, h, w = image.shape
  if h > 12_000:
    raise ValueError(f'noise_chain: height {h} exceeds the shared-memory '
                     'row-shift table.')
  lib = _build.load('noise_chain')
  fn = lib.noise_chain_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
      ctypes.c_void_p
  ]
  out = torch.empty_like(image)
  scratch = torch.empty_like(image)
  d = [None] * 8 if draws is None else [
      draws[k] for k in PIXEL_DRAWS + ROW_DRAWS
  ]
  status = fn(
      _build.ptr(image), _build.ptr(out), _build.ptr(scratch),
      _build.ptr(packed), _build.ptr(seeds), *[_build.ptr(t) for t in d],
      b, h, w, _build.stream_ptr(image.device),
  )
  _build.check_status('noise_chain', status)
  _build.count_launch('noise_chain')
  return out


def noise_chain(
    image: torch.Tensor,
    packed: torch.Tensor,
    *,
    gen: Optional[torch.Generator] = None,
    seeds: Optional[torch.Tensor] = None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
  """Runs the noise chain on a (B, H, W) f32 batch.

  CUDA tensors launch the kernel: with `draws` (injected mode) it reads
  them; otherwise it draws in-kernel from Philox keyed by per-image
  `seeds` ((B,) int64), which are themselves drawn from `gen` when not
  given. CPU tensors run the plain twin (with `draws`, or draws from
  `gen`).
  """
  _build.check_tensor(image, 'image', torch.float32, 3)
  b, h, w = image.shape
  _build.check_tensor(packed, 'packed', torch.float32, 2)
  if packed.shape != (b, 8):
    raise ValueError(f'packed: expected ({b}, 8), got {tuple(packed.shape)}.')
  if draws is not None:
    for k in PIXEL_DRAWS:
      _build.check_tensor(draws[k], k, torch.float32, 3)
      if draws[k].shape != image.shape:
        raise ValueError(f'{k}: expected {tuple(image.shape)}.')
    for k in ROW_DRAWS:
      _build.check_tensor(draws[k], k, torch.float32, 2)
      if draws[k].shape != (b, h):
        raise ValueError(f'{k}: expected ({b}, {h}).')
  if image.device.type == 'cpu':
    return noise_chain_reference(image, packed, draws=draws, gen=gen)
  if not image.is_cuda:
    raise ValueError(f'noise_chain: unsupported device {image.device}.')
  tensors = [packed] + ([] if draws is None else list(draws.values()))
  if any(t.device != image.device for t in tensors):
    raise ValueError('noise_chain: all tensors must be on one device.')
  if draws is None:
    if seeds is None:
      if gen is None:
        raise ValueError('noise_chain needs draws, seeds or a generator.')
      seeds = torch.randint(0, 2**62, (b,), generator=gen,
                            device=image.device, dtype=torch.int64)
    _build.check_tensor(seeds, 'seeds', torch.int64, 1)
    if seeds.shape[0] != b or seeds.device != image.device:
      raise ValueError('seeds: expected (B,) int64 on the image device.')
  return _launch(image, packed, seeds if draws is None else None, draws)
