"""Domain-randomized image-generation parameter sampling.

Port of putting_dune_tpu/imaging/params.py, vectorized over a batch.
"""

from __future__ import annotations

import torch

from putting_dune_torch import structures


def sample_imaging_params(
    gen: torch.Generator, batch_size: int, *, device, noisy: bool = False
) -> structures.ImagingParams:
  """Samples per-environment imaging parameters, each (B,) float32.

  noisy=False is the default sampler; noisy=True the very-noisy variant.
  """
  b = (batch_size,)

  def u(lo, hi):
    return torch.rand(b, generator=gen, device=device) * (hi - lo) + lo

  intensity_exponent = u(1.4, 2.0)
  gaussian_variance = u(0.0, 0.3 if noisy else 5e-3)
  jitter_rate = u(0.0, 5.0)
  poisson = torch.empty(b, device=device).exponential_(generator=gen)
  salt_and_pepper_amount = u(0.0, 1e-2 if noisy else 1e-3)
  blur_amount = u(0.0, 0.25 if noisy else 1.0)
  contrast_gamma = u(0.5, 1.5) if noisy else u(0.7, 1.3)
  exponential_lambda = u(0.0, 0.25 if noisy else 0.2)
  uniform_noise_scale = u(0.0, 0.25 if noisy else 0.2)
  return structures.ImagingParams(
      intensity_exponent=intensity_exponent,
      gaussian_variance=gaussian_variance,
      jitter_rate=jitter_rate,
      poisson_rate_multiplier=poisson * 15.0 + 1.0,
      salt_and_pepper_amount=salt_and_pepper_amount,
      blur_amount=blur_amount,
      contrast_gamma=contrast_gamma,
      exponential_lambda=exponential_lambda,
      uniform_noise_scale=uniform_noise_scale,
  )
