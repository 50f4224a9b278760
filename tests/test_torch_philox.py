"""The noise kernel's generator in plain PyTorch: Philox4x32-10 and the draws.

`philox4x32_10` is held against the known-answer vectors of the Random123
distribution (Salmon et al., SC'11, `kat_vectors`), `draws_from_seeds`
against the laws its fields must follow, and the noise chain's twin is
driven with its draws. All on the CPU; on the card the CUDA kernel is
held pixel by pixel against this twin (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from putting_dune_torch.ops import noise_fused

torch.set_num_threads(2)


def _words(*values):
  return torch.tensor(values, dtype=torch.int64)


@pytest.mark.parametrize('key,counter,want', [
    ((0, 0), (0, 0, 0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff, 0xffffffff),
     (0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0xa4093822, 0x299f31d0),
     (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(key, counter, want):
  got = noise_fused.philox4x32_10(_words(*key), _words(*counter))
  assert got.dtype == torch.int64 and got.shape == (4,)
  assert [int(v) for v in got] == list(want)


def test_philox_broadcasts_and_matches_one_by_one():
  rng = np.random.default_rng(0)
  keys = torch.from_numpy(rng.integers(0, 2**32, (3, 1, 2)))
  counters = torch.from_numpy(rng.integers(0, 2**32, (3, 5, 4)))
  got = noise_fused.philox4x32_10(keys, counters)
  assert got.shape == (3, 5, 4)
  assert int(got.min()) >= 0 and int(got.max()) < 2**32
  for i in range(3):
    for j in range(5):
      one = noise_fused.philox4x32_10(keys[i, 0], counters[i, j])
      assert torch.equal(one, got[i, j])


def test_uniform_mapping_is_strictly_inside_the_unit_interval():
  bits = _words(0, 1, 511, 512, 2**31, 2**32 - 1)
  u = noise_fused._uniform_from_bits(bits)
  assert u.dtype == torch.float32
  # (2k + 1) * 2^-24 for the top 23 bits k.
  k = (bits >> 9).numpy().astype(np.float64)
  np.testing.assert_array_equal(u.numpy().astype(np.float64),
                                (2 * k + 1) / 2**24)
  assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def _draws(seed_values, h=48, w=40):
  seeds = torch.tensor(seed_values, dtype=torch.int64)
  return noise_fused.draws_from_seeds(seeds, len(seed_values), h, w, 'cpu')


def test_draws_from_seeds_shapes_ranges_and_determinism():
  b, h, w = 3, 48, 40
  draws = _draws([7, 2**61 + 11, 7], h, w)
  assert set(draws) == set(noise_fused.PIXEL_DRAWS + noise_fused.ROW_DRAWS)
  for name in noise_fused.PIXEL_DRAWS:
    assert draws[name].shape == (b, h, w) and draws[name].dtype == torch.float32
  for name in noise_fused.ROW_DRAWS:
    assert draws[name].shape == (b, h)
  for name in ('u_pois', 'u_sp', 'u_un', 'u_ex', 'u_row'):
    assert float(draws[name].min()) > 0.0 and float(draws[name].max()) < 1.0
  for name in ('z_pois', 'z_gauss', 'z_row'):
    assert bool(torch.isfinite(draws[name]).all())
  again = _draws([7, 2**61 + 11, 7], h, w)
  for name, value in draws.items():
    assert torch.equal(value, again[name])
    # The frame index is part of the counter: two frames with one seed
    # differ, as do two seeds.
    assert not torch.equal(value[0], value[2])
    assert not torch.equal(value[0], value[1])


def test_draws_from_seeds_do_not_depend_on_the_batch():
  """A frame's draws are a function of (seed, frame index, pixel) alone."""
  full = _draws([5, 9, 13])
  head = _draws([5, 9])
  for name in full:
    assert torch.equal(full[name][:2], head[name])


def test_draws_from_seeds_use_the_documented_counters():
  h, w = 4, 6
  seed = (0x299f31d0 << 32) | 0xa4093822
  draws = _draws([3, seed], h, w)
  key = _words(0xa4093822, 0x299f31d0)
  pixel = 2 * w + 5
  block0 = noise_fused.philox4x32_10(key, _words(pixel, 0, 1, 0))
  block1 = noise_fused.philox4x32_10(key, _words(pixel, 1, 1, 0))
  row = noise_fused.philox4x32_10(key, _words(2, 2, 1, 0))
  u = noise_fused._uniform_from_bits
  assert float(draws['u_pois'][1, 2, 5]) == float(u(block0[2]))
  assert float(draws['u_sp'][1, 2, 5]) == float(u(block0[3]))
  assert float(draws['u_un'][1, 2, 5]) == float(u(block1[0]))
  assert float(draws['u_ex'][1, 2, 5]) == float(u(block1[1]))
  assert float(draws['u_row'][1, 2]) == float(u(row[0]))
  z_pois, z_gauss = noise_fused._box_muller(u(block0[0]), u(block0[1]))
  assert float(draws['z_pois'][1, 2, 5]) == float(z_pois)
  assert float(draws['z_gauss'][1, 2, 5]) == float(z_gauss)
  z_row, _ = noise_fused._box_muller(u(row[1]), u(row[2]))
  assert float(draws['z_row'][1, 2]) == float(z_row)


# 4 x 96 x 80 = 30,720 draws per pixel field: |z| <= 4.5 on each statistic
# fails by chance about 7e-6 of the time per check.
Z_BOUND = 4.5


@pytest.mark.parametrize('name', noise_fused.PIXEL_DRAWS)
def test_pixel_draw_fields_have_the_right_moments(name):
  draws = _draws([1, 2, 3, 4], 96, 80)
  x = draws[name].double().flatten().numpy()
  n = x.size
  if name.startswith('u_'):
    mean, var, var_of_sq = 0.5, 1.0 / 12.0, 1.0 / 180.0
  else:
    mean, var, var_of_sq = 0.0, 1.0, 2.0
  z_mean = (x.mean() - mean) / np.sqrt(var / n)
  z_var = (((x - mean) ** 2).mean() - var) / np.sqrt(var_of_sq / n)
  assert abs(z_mean) <= Z_BOUND, (name, z_mean)
  assert abs(z_var) <= Z_BOUND, (name, z_var)


def test_fields_are_uncorrelated_with_each_other():
  draws = _draws([21, 22], 96, 80)
  names = list(noise_fused.PIXEL_DRAWS)
  x = np.stack([draws[k].double().flatten().numpy() for k in names])
  corr = np.corrcoef(x)
  n = x.shape[1]
  off = corr - np.eye(len(names))
  # A sample correlation of independent fields is ~ N(0, 1 / n).
  assert np.abs(off).max() * np.sqrt(n) <= Z_BOUND, off


@pytest.mark.parametrize('shape', [(2, 32, 48), (1, 17, 9)])
def test_twin_fed_draws_from_seeds_is_finite_and_in_range(shape):
  b, h, w = shape
  rng = np.random.default_rng(3)
  image = torch.from_numpy(rng.uniform(size=shape).astype(np.float32) ** 3)
  packed = torch.zeros((b, 8))
  packed[:, 0] = torch.tensor([20.0, 3.0][:b])
  packed[:, 1] = 2.0
  packed[:, 2] = 0.02
  packed[:, 3] = 0.9
  packed[:, 4] = 0.1
  packed[:, 5] = 0.1
  packed[:, 6] = 1e-3
  seeds = torch.arange(b, dtype=torch.int64) + 100
  draws = noise_fused.draws_from_seeds(seeds, b, h, w, 'cpu')
  out = noise_fused.noise_chain_reference(image, packed, draws=draws)
  assert out.shape == image.shape and out.dtype == torch.float32
  assert bool(torch.isfinite(out).all())
  assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
  # The CPU path of the wrapper is the same twin.
  same = noise_fused.noise_chain(image, packed, draws=draws)
  assert torch.equal(out, same)
