"""CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`; each test asks the `cuda` fixture for the device, which
skips when no card is present (the decision is made at run time, never at
import). Run on a GPU machine with:

  python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
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
  # 128^2 takes the one-launch CLAHE kernel, 256^2 the split pair.
  for size, launched in [(128, ('noise_chain', 'clahe_small')),
                         (256, ('noise_chain', 'clahe_hist_lut',
                                'clahe_remap'))]:
    image = torch.rand((2, size, size), generator=gen, device=cuda)
    before = dict(_build.LAUNCHES)
    noisy = noise_fused.noise_chain(image, _packed(2, cuda), gen=gen)
    out = t_clahe.equalize_adapthist(noisy)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    for name in _build.KERNELS:
      want = before[name] + (1 if name in launched else 0)
      assert _build.LAUNCHES[name] == want, (size, name)


def _skewed(shape, seed, device):
  gen = torch.Generator(device=device).manual_seed(seed)
  return torch.rand(shape, generator=gen, device=device) ** 2.5


@pytest.mark.parametrize('shape,grid,nbins', [
    ((16, 128, 128), 8, 256), ((16, 128, 128), 8, 128), ((4, 64, 64), 8, 256),
    ((4, 64, 64), 4, 100), ((3, 96, 160), 8, 256)])
def test_clahe_small_matches_twin_and_split_pair(cuda, shape, grid, nbins):
  image = _skewed(shape, 3, cuda)
  got, hist = clahe_fused.clahe_small(image, 0.01, grid, nbins,
                                      return_hist=True)
  want_hist, _ = clahe_fused.hist_lut_reference(image, grid, 0.01, nbins)
  want = clahe_fused.clahe_reference(image, 0.01, grid, nbins)
  torch.cuda.synchronize()
  assert torch.equal(hist, want_hist)
  assert float((got - want).abs().max()) <= 2e-5
  # The split pair shares the kernel's arithmetic: identical output.
  pair_hist, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  pair = clahe_fused.clahe_remap(image, mapping)
  assert torch.equal(pair_hist, hist)
  assert float((got - pair).abs().max()) == 0.0
  assert torch.equal(got, clahe_fused.clahe_small(image, 0.01, grid, nbins))


@pytest.mark.parametrize('shape,grid,nbins', [
    ((8, 256, 256), 8, 256), ((4, 384, 384), 8, 256), ((8, 128, 128), 8, 128),
    ((2, 256, 256), 4, 1024), ((2, 200, 120), 4, 77)])
def test_clahe_pair_matches_twins_at_any_nbins(cuda, shape, grid, nbins):
  image = _skewed(shape, 4, cuda)
  hist, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  want_hist, want_mapping = clahe_fused.hist_lut_reference(
      image, grid, 0.01, nbins)
  assert torch.equal(hist, want_hist)
  assert float((mapping - want_mapping).abs().max()) <= 2e-5
  got = clahe_fused.clahe_remap(image, mapping)
  want = clahe_fused.clahe_reference(image, 0.01, grid, nbins)
  torch.cuda.synchronize()
  assert float((got - want).abs().max()) <= 2e-5


def test_clahe_wrappers_refuse_on_cuda(cuda):
  image = torch.zeros((1, 128, 128), device=cuda)
  with pytest.raises(ValueError, match='nbins'):
    clahe_fused.clahe_hist_lut(image, nbins=2048)
  with pytest.raises(ValueError, match='nbins'):
    clahe_fused.clahe_small(image, nbins=1)
  with pytest.raises(ValueError, match='shared memory'):
    clahe_fused.clahe_small(torch.zeros((1, 64, 64), device=cuda),
                            grid_size=16, nbins=1024)
