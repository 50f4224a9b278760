"""Fused STEM noise chain: the CUDA kernel's wrapper and its plain twin.

Port of putting_dune_tpu/ops/noise_fused_pallas.py. `noise_chain` runs the
seven post-splat noise stages (Poisson shot noise, row jitter, salt &
pepper, gamma contrast, uniform, exponential, Gaussian) in one launch of
csrc/noise_chain.cu on CUDA tensors, with in-kernel Philox draws or, in
the injected mode, with draws read from tensors. On CPU tensors it runs
`noise_chain_reference`, a PyTorch transcription of the JAX package's
`chain_from_uniforms`, which is also the kernel's oracle on the card.

The kernel's generator has a plain twin too: `philox4x32_10` is
Philox4x32-10 on integer tensors and `draws_from_seeds` derives the eight
draw fields from per-image seeds exactly as the kernel does from its
counters, so `noise_chain(image, packed, seeds=s)` can be held pixel by
pixel against `noise_chain_reference(image, packed,
draws=draws_from_seeds(s, ...))`.

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
from putting_dune_torch.utils import profiling

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
  with profiling.span('sync.noise_jitter'):
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


# --- the kernel's generator, in plain PyTorch -----------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """(high, low) 32-bit words of m * x for 32-bit values held in int64,
  through 16-bit halves of x so that no product leaves 63 bits."""
  low = m * (x & 0xFFFF)
  mid = m * (x >> 16) + (low >> 16)
  return mid >> 16, ((mid & 0xFFFF) << 16) | (low & 0xFFFF)


def philox4x32_10(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
  """Philox4x32-10 (Salmon et al., SC'11) on integer tensors.

  Args:
    key: (..., 2) int64 holding 32-bit words.
    counter: (..., 4) int64 holding 32-bit words, broadcastable with key.

  Returns:
    (..., 4) int64 holding the four 32-bit output words.
  """
  k0, k1 = key[..., 0] & _MASK32, key[..., 1] & _MASK32
  c0, c1, c2, c3 = (counter[..., j] & _MASK32 for j in range(4))
  for rnd in range(10):
    if rnd:
      k0 = (k0 + _PHILOX_W0) & _MASK32
      k1 = (k1 + _PHILOX_W1) & _MASK32
    hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
    hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
    c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
  return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
  """(2k + 1) * 2^-24 for the top 23 bits k of a 32-bit word: in (0, 1),
  exact in f32 (the kernel's `uniform`)."""
  return ((bits >> 9).to(torch.float32) * (1.0 / 8388608.0)
          + (1.0 / 16777216.0))


def draws_from_seeds(
    seeds: torch.Tensor, batch: int, height: int, width: int, device
) -> dict[str, torch.Tensor]:
  """The draws the kernel derives in Philox mode from per-image `seeds`.

  Key: the low and high words of the seed. Counter (pixel, 0, frame, 0)
  gives the Box-Muller pair (z_pois the cosine branch, z_gauss the sine
  branch), u_pois and u_sp; (pixel, 1, frame, 0) gives u_un and u_ex;
  (row, 2, frame, 0) gives u_row and z_row.
  """
  seeds = seeds.to(device=device, dtype=torch.int64).reshape(batch)
  key = torch.stack([seeds & _MASK32, (seeds >> 32) & _MASK32], dim=-1)
  frame = torch.arange(batch, device=device, dtype=torch.int64)

  def block(count: int, which: int) -> torch.Tensor:
    counter = torch.zeros((batch, count, 4), dtype=torch.int64, device=device)
    counter[..., 0] = torch.arange(count, device=device)
    counter[..., 1] = which
    counter[..., 2] = frame[:, None]
    return philox4x32_10(key[:, None, :], counter)

  def uniforms(words: torch.Tensor, shape) -> list[torch.Tensor]:
    return [_uniform_from_bits(words[..., j]).reshape(shape)
            for j in range(4)]

  pixel = (batch, height, width)
  u1, u2, u_pois, u_sp = uniforms(block(height * width, 0), pixel)
  z_pois, z_gauss = _box_muller(u1, u2)
  u_un, u_ex, _, _ = uniforms(block(height * width, 1), pixel)
  u_row, r1, r2, _ = uniforms(block(height, 2), (batch, height))
  z_row, _ = _box_muller(r1, r2)
  return {
      'u_pois': u_pois, 'z_pois': z_pois, 'u_sp': u_sp, 'u_un': u_un,
      'u_ex': u_ex, 'z_gauss': z_gauss, 'u_row': u_row, 'z_row': z_row,
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
  plan = _build.function('noise_chain', 'noise_chain_scratch_floats',
                         [ctypes.c_int] * 3, restype=ctypes.c_longlong)
  # A frame is split by rows over at most 16 blocks, each of which keeps
  # its rows on chip (12 bytes a pixel, up to ~19,000 pixels); a larger
  # frame needs 12 bytes a pixel of device scratch instead. The kernel
  # refuses only a sixteenth of a frame of 2^30 pixels or more, or of more
  # than 57,000 rows.
  scratch_floats = plan(b, h, w)
  if scratch_floats < 0:
    raise ValueError(
        f'noise_chain: shape {(b, h, w)} is empty or exceeds the kernel\'s '
        'limits.')
  fn = _build.function('noise_chain', 'noise_chain_launch',
                       [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
  out = torch.empty_like(image)
  scratch = (torch.empty((scratch_floats,), device=image.device)
             if scratch_floats else None)
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
