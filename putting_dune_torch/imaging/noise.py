"""The STEM noise operators, one stage at a time.

Port of putting_dune_tpu/imaging/noise.py. Each operator takes (B, H, W)
float32 frames, per-frame (B,) parameters and (where it draws) a
torch.Generator on the frames' device. Chained in this order they are the
stage-wise noise of `render.render_stem_image(noise_backend='stages')`:
the same laws as the fused `noise_chain` kernel (the default), one launch
per operation instead of one for the chain. The PRNG streams differ from
the JAX package's, so the two agree in law
(tests/test_torch_perception_train.py).

  * Poisson shot noise, max-normalized: the fast sampler (12-term CDF
    inversion below lambda 4, a rounded normal above) or, with exact=True,
    torch.poisson.
  * Row jitter: row y rolled right by s_y ~ Poisson(jitter_rate) pixels
    (np.roll); a gather here, an FFT phase rotation in the JAX package,
    which is the same shift up to float32 rounding.
  * Salt and pepper: one uniform per pixel, below amount / 2 salt (1),
    below amount pepper (0).
  * Gamma contrast: max(image, 0) ** gamma.
  * Additive U(0, scale) and Exp(scale) noise, each max-normalized.
  * Additive N(0, variance) noise, clipped to [0, 1].
"""

from __future__ import annotations

import torch

from putting_dune_torch.ops import noise_fused


def _poisson_fast(gen: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
  u = torch.rand(lam.shape, generator=gen, device=lam.device)
  z = torch.randn(lam.shape, generator=gen, device=lam.device)
  return noise_fused._poisson_from_draws(u, z, lam)


def apply_poisson_noise(gen: torch.Generator, image: torch.Tensor,
                        rate_multiplier: torch.Tensor, *,
                        exact: bool = False) -> torch.Tensor:
  lam = image * rate_multiplier[:, None, None]
  counts = (torch.poisson(lam, generator=gen) if exact
            else _poisson_fast(gen, lam))
  return noise_fused._renorm(counts)


def apply_jitter(gen: torch.Generator, image: torch.Tensor,
                 jitter_rate: torch.Tensor) -> torch.Tensor:
  b, h, w = image.shape
  lam = jitter_rate[:, None].expand(b, h).to(image.dtype)
  shifts = _poisson_fast(gen, lam).to(torch.int64)
  lane = torch.arange(w, device=image.device)
  return torch.gather(image, -1, torch.remainder(lane - shifts[..., None], w))


def apply_salt_and_pepper(gen: torch.Generator, image: torch.Tensor,
                          amount: torch.Tensor) -> torch.Tensor:
  u = torch.rand(image.shape, generator=gen, device=image.device)
  a = amount[:, None, None]
  image = torch.where(u < a / 2.0, 1.0, image)
  return torch.where((u >= a / 2.0) & (u < a), 0.0, image)


def apply_contrast(image: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
  return torch.pow(torch.clamp(image, min=0.0), gamma[:, None, None])


def apply_uniform_noise(gen: torch.Generator, image: torch.Tensor,
                        noise_scale: torch.Tensor) -> torch.Tensor:
  noise = torch.rand(image.shape, generator=gen, device=image.device)
  return noise_fused._renorm(image + noise * noise_scale[:, None, None])


def apply_exponential_noise(gen: torch.Generator, image: torch.Tensor,
                            noise_scale: torch.Tensor) -> torch.Tensor:
  noise = torch.empty_like(image).exponential_(generator=gen)
  return noise_fused._renorm(image + noise * noise_scale[:, None, None])


def apply_gaussian_noise(gen: torch.Generator, image: torch.Tensor,
                         variance: torch.Tensor) -> torch.Tensor:
  noise = torch.randn(image.shape, generator=gen, device=image.device)
  return torch.clamp(image + noise * torch.sqrt(variance)[:, None, None],
                     0.0, 1.0)


def apply_stages(gen: torch.Generator, image: torch.Tensor, params
                 ) -> torch.Tensor:
  """The seven operators in the renderer's order, with the frames'
  `structures.ImagingParams`."""
  image = apply_poisson_noise(gen, image, params.poisson_rate_multiplier)
  image = apply_jitter(gen, image, params.jitter_rate)
  image = apply_salt_and_pepper(gen, image, params.salt_and_pepper_amount)
  image = apply_contrast(image, params.contrast_gamma)
  image = apply_uniform_noise(gen, image, params.uniform_noise_scale)
  image = apply_exponential_noise(gen, image, params.exponential_lambda)
  return apply_gaussian_noise(gen, image, params.gaussian_variance)
