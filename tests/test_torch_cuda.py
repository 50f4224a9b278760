"""CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`; each test asks the `cuda` fixture for the device, which
skips when no card is present (the decision is made at run time, never at
import). Run on a GPU machine with:

  python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from putting_dune_torch.imaging import clahe as t_clahe
from putting_dune_torch.ops import _build
from putting_dune_torch.ops import clahe_fused
from putting_dune_torch.ops import noise_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def _packed(b, device):
  rng = np.random.default_rng(0)
  p = np.zeros((b, 8), np.float32)
  p[:, 0] = rng.exponential(size=b) * 15 + 1
  p[:, 1] = rng.uniform(0, 5, b)
  p[:, 2] = rng.uniform(0, 0.05, b)
  p[:, 3] = rng.uniform(0.7, 1.3, b)
  p[:, 4] = rng.uniform(0, 0.2, b)
  p[:, 5] = rng.uniform(0, 0.2, b)
  p[:, 6] = rng.uniform(0, 5e-3, b)
  return torch.from_numpy(p).to(device)


def test_noise_chain_injected_matches_twin(cuda):
  gen = torch.Generator(device=cuda).manual_seed(0)
  b, h, w = 4, 256, 256
  image = torch.rand((b, h, w), generator=gen, device=cuda)
  packed = _packed(b, cuda)
  draws = noise_fused.sample_draws(gen, b, h, w, cuda)
  got = noise_fused.noise_chain(image, packed, draws=draws)
  want = noise_fused.noise_chain_reference(image, packed, draws=draws)
  torch.cuda.synchronize()
  assert float((got - want).abs().max()) <= 1e-5


def test_clahe_kernels_match_twins(cuda):
  gen = torch.Generator(device=cuda).manual_seed(1)
  image = torch.rand((3, 512, 512), generator=gen, device=cuda)
  hist, mapping = clahe_fused.clahe_hist_lut(image)
  want_hist, want_mapping = clahe_fused.hist_lut_reference(image)
  torch.testing.assert_close(hist, want_hist, rtol=0, atol=0)
  assert float((mapping - want_mapping).abs().max()) <= 2e-5
  got = clahe_fused.clahe_remap(image, mapping)
  want = clahe_fused.clahe_reference(image)
  assert float((got - want).abs().max()) <= 2e-5


def test_cuda_path_never_calls_the_twins(cuda, monkeypatch):
  def boom(*args, **kwargs):
    raise AssertionError('a plain twin ran on a CUDA tensor')

  for module, name in [(noise_fused, 'noise_chain_reference'),
                       (noise_fused, 'chain_from_uniforms'),
                       (clahe_fused, 'hist_lut_reference'),
                       (clahe_fused, 'remap_reference'),
                       (clahe_fused, 'clahe_reference')]:
    monkeypatch.setattr(module, name, boom)
  gen = torch.Generator(device=cuda).manual_seed(2)
  image = torch.rand((2, 128, 128), generator=gen, device=cuda)
  before = dict(_build.LAUNCHES)
  noisy = noise_fused.noise_chain(image, _packed(2, cuda), gen=gen)
  out = t_clahe.equalize_adapthist(noisy)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(out).all())
  for name in _build.KERNELS:
    assert _build.LAUNCHES[name] == before[name] + 1, name
