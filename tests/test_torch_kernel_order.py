"""The order-exact plain versions (the oracles the CLAHE and splat kernels
are held to bit for bit on the card) against the plain twins and against
the JAX package, on the CPU. Inputs are made with numpy from a seed;
tolerances are stated at each test. Also: the kernel build's hash covers
the headers a source includes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch.ops import _build
from putting_dune_torch.ops import clahe_fused as t_cf
from putting_dune_torch.ops import splat as t_splat
from putting_dune_tpu.imaging import clahe as j_clahe
from putting_dune_tpu.ops import splat_pallas as j_splat

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


def _frames(seed, shape):
  rng = np.random.default_rng(seed)
  return (rng.uniform(size=shape) ** 2.5).astype(np.float32)


# 256 bins at grid 8; 100 and 1024 bins; a 6 x 6 grid; an odd tile width
# (41 pixels, the scalar-load route of the kernel); 2 bins.
CLAHE_CASES = [
    ((2, 128, 128), 8, 256), ((2, 96, 160), 8, 100), ((1, 128, 128), 4, 1024),
    ((2, 240, 360), 6, 256), ((1, 264, 328), 8, 256), ((2, 66, 90), 3, 2),
]


@pytest.mark.parametrize('shape,grid,nbins', CLAHE_CASES)
def test_order_exact_mapping_matches_the_twin(shape, grid, nbins):
  img = _t(_frames(1, shape))
  hist, mapping = t_cf.hist_lut_order_exact(img, grid, 0.01, nbins)
  want_hist, want_mapping = t_cf.hist_lut_reference(img, grid, 0.01, nbins)
  assert torch.equal(hist, want_hist)
  assert mapping.shape == (shape[0], grid, grid, nbins)
  # The same sums in another order: a few f32 ulps of values in (0, 1].
  assert float((mapping - want_mapping).abs().max()) <= 1e-6
  assert float(mapping[..., -1].min()) == 1.0


# JAX's XLA route sums quadrants of tiles, so its tiles have even sides:
# 34 x 42 pixels stand in for the odd width (42 is no multiple of 4 either).
@pytest.mark.parametrize('shape,grid,nbins', [
    ((2, 128, 128), 8, 256), ((2, 96, 160), 8, 100), ((1, 128, 128), 4, 1024),
    ((2, 240, 360), 6, 256), ((1, 272, 336), 8, 256), ((2, 66, 90), 3, 2),
])
def test_order_exact_mapping_matches_jax(shape, grid, nbins):
  """JAX's CLAHE (putting_dune_tpu/imaging/clahe.py, the XLA route)
  against the port's remap of the order-exact mapping: the mapping enters
  every output pixel through the bilinear blend."""
  img = _frames(2, shape)
  want = np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), grid_size=grid, nbins=nbins, backend='xla'))
  _, mapping = t_cf.hist_lut_order_exact(_t(img), grid, 0.01, nbins)
  got = t_cf.remap_reference(_t(img), mapping).numpy()
  # The tolerance tests/test_torch_imaging.py holds the port's CLAHE to.
  assert np.abs(got - want).max() <= 1e-5


def test_order_exact_mapping_takes_the_kernel_order():
  """A tile whose excess sum depends on the order: the order-exact version
  repeats the kernels' 256-thread sums (per-thread strides, butterfly,
  groups in sequence), which need not equal torch.sum's bits; and a
  monotone, normalized cdf."""
  rng = np.random.default_rng(3)
  img = (rng.uniform(size=(4, 64, 64)) ** 6).astype(np.float32)
  hist, mapping = t_cf.hist_lut_order_exact(_t(img), 1, 0.001, 1024)
  m = mapping.numpy()
  assert np.all(np.diff(m, axis=-1) >= 0)
  np.testing.assert_array_equal(m[..., -1], 1.0)
  # Recompute the kernels' excess sum in float32 numpy, step by step.
  hf = hist.numpy().astype(np.float32)[:, 0, 0]
  clim = np.float32(t_cf.clip_limit_count(0.001, 64 * 64))
  ex = np.maximum(hf - clim, np.float32(0))
  e = ex.reshape(4, 4, 256)
  part = e[:, 0]
  for i in range(1, 4):
    part = (part + e[:, i]).astype(np.float32)
  lanes = np.arange(256)
  for off in (16, 8, 4, 2, 1):
    part = (part + part[:, lanes ^ off]).astype(np.float32)
  total = np.zeros(4, np.float32)
  for g in range(8):
    total = (total + part[:, 32 * g]).astype(np.float32)
  cur = np.minimum(hf, clim) + (total / np.float32(1024))[:, None]
  cur = cur.astype(np.float32)
  off = 1
  while off < 1024:
    cur = np.concatenate([cur[:, :off], cur[:, off:] + cur[:, :-off]], -1)
    off *= 2
  np.testing.assert_array_equal(m[:, 0, 0], (cur / cur[:, -1:]))


def _splat_operands(seed, b, k, s, sigma_scale=1.0):
  """Integer bins of a jittered grid at graphene's bond length in pixels,
  carbon weights with two silicons, a masked tail, sigmas near S / 54."""
  rng = np.random.default_rng(seed)
  pitch = s / 17.6
  n = int(np.ceil(np.sqrt(k)))
  gx, gy = np.meshgrid(np.arange(n), np.arange(n))
  base = np.stack([gx.ravel(), gy.ravel()], -1)[:k] * pitch
  pos = (base[None] + rng.uniform(0, max(s - n * pitch, 1.0), (b, 1, 2))
         + rng.normal(0, 0.3, (b, k, 2)))
  bins = np.clip(np.floor(pos), 0, s - 1).astype(np.float32)
  w = np.full((b, k), 6.0 ** 1.7, np.float32)
  for i in range(b):
    w[i, rng.choice(k, 2, replace=False)] = 14.0 ** 1.7
  w[:, (2 * k) // 3:] = 0.0
  scale = rng.uniform(0.9, 1.1, (2, b)) * s / 53.75 * sigma_scale
  sx, sy = scale.astype(np.float32)
  return bins[..., 0].copy(), bins[..., 1].copy(), w, sx, sy


# One frame with K not a multiple of 32 at S = 200; a radius (~37 rows)
# above a band's height; S = 100.
@pytest.mark.parametrize('seed,b,k,s,scale', [
    (0, 1, 77, 200, 1.0), (1, 2, 40, 128, 8.0), (2, 3, 50, 100, 1.0)])
def test_atom_order_splat_matches_the_twin(seed, b, k, s, scale):
  ops = [_t(a) for a in _splat_operands(seed, b, k, s, scale)]
  got = t_splat.splat_render_atom_order(*ops, image_size=s)
  want = t_splat.splat_render_reference(*ops, image_size=s)
  assert got.shape == (b, s, s)
  # The same f32 products summed in atom order and by torch.bmm.
  assert float((got - want).abs().max()) <= 1e-6
  assert float(got.amax()) == 1.0 and float(got.min()) >= 0.0


@pytest.mark.parametrize('seed,b,k', [(0, 2, 96), (2, 3, 40)])
def test_atom_order_splat_matches_pallas_interpret(seed, b, k):
  s = 128  # the Pallas kernel gathers 128-lane segments
  ops = _splat_operands(seed, b, k, s)
  want = np.asarray(j_splat.splat_render(
      *[jnp.asarray(a) for a in ops], image_size=s, interpret=True))
  got = t_splat.splat_render_atom_order(
      *[_t(a) for a in ops], image_size=s).numpy()
  # The Pallas kernel contracts bf16 factors; the port keeps f32
  # (tests/test_torch_splat_interp.py holds the twin to the same bar).
  assert np.abs(got - want).max() <= 5e-3


def test_atom_order_splat_sums_atom_by_atom():
  """Two atoms on one pixel: the frame is ((w0 fy0) fx0 + (w1 fy1) fx1),
  in that order, before the divide."""
  s = 16
  bx = torch.tensor([[5.0, 6.0]])
  by = torch.tensor([[9.0, 9.0]])
  w = torch.tensor([[2.0, 3.0]])
  sigma = torch.tensor([1.3])
  got = t_splat.splat_render_atom_order(bx, by, w, sigma, sigma,
                                        image_size=s)
  prof = t_splat._profile(sigma, s)[0]  # prof[j] at distance j - S
  row = s - 1 - 9
  fy = prof[s]  # the atoms' own row
  acc = torch.zeros(s)
  for k, x0 in enumerate((5, 6)):
    fx = prof[torch.arange(s) - x0 + s]
    acc = acc + (w[0, k] * fy) * fx
  # The peak of the frame lies on the atoms' row.
  assert torch.equal(got[0, row], acc / acc.max())


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
  """An edited header names a new library: a stale .so is never reused."""
  (tmp_path / 'k.cu').write_text('#include "h.cuh"\nint f() { return 1; }\n')
  (tmp_path / 'h.cuh').write_text('#pragma once\n#include "g.cuh"\n')
  (tmp_path / 'g.cuh').write_text('// 1\n')
  (tmp_path / 'other.cuh').write_text('// not included\n')
  monkeypatch.setattr(_build, 'SRC_DIR', tmp_path)
  first = _build.library_path('k')
  assert [p.name for p in _build._sources('k')] == ['k.cu', 'h.cuh', 'g.cuh']
  (tmp_path / 'other.cuh').write_text('// edited\n')
  assert _build.library_path('k') == first
  (tmp_path / 'g.cuh').write_text('// 2\n')
  second = _build.library_path('k')
  assert second != first
  (tmp_path / 'h.cuh').write_text('#pragma once\n#include "g.cuh"\n// x\n')
  assert _build.library_path('k') not in (first, second)


def test_clahe_sources_share_the_lut_header():
  for name in ('clahe_hist_lut', 'clahe_small'):
    names = [p.name for p in _build._sources(name)]
    assert names == [f'{name}.cu', 'clahe_lut.cuh']
  assert [p.name for p in _build._sources('splat_render')] == [
      'splat_render.cu']
