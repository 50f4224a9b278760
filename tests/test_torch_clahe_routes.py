"""Port parity for every CLAHE route: bins, grids, size classes, padding.

Seeded numpy frames go through the JAX package (`backend='xla'` on the
CPU, and the fused Pallas kernel in interpret mode) and through the port,
whose wrappers run their plain twins on CPU tensors. Tolerance 1e-5
throughout: both sides compute in f32 and differ only in the order of the
cdf sums (the interpret-mode Pallas lookup is exact f32 too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch.imaging import clahe as t_clahe
from putting_dune_torch.ops import clahe_fused as t_cf
from putting_dune_tpu.imaging import clahe as j_clahe
from putting_dune_tpu.ops import clahe_fused_pallas as j_cfp

torch.set_num_threads(2)

TOL = 1e-5


def _frames(seed, b, h, w):
  rng = np.random.default_rng(seed)
  # A skewed law, so the clip limit bites in some tiles and not in others.
  return (rng.uniform(size=(b, h, w)) ** 2.5).astype(np.float32)


def _jax_xla(img, **kw):
  return np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), backend='xla', **kw))


@pytest.mark.parametrize('grid_size,nbins', [(4, 256), (8, 128)])
def test_nbins_and_grid_match_jax(grid_size, nbins):
  img = _frames(33, 2, 64, 64)
  want = _jax_xla(img, grid_size=grid_size, nbins=nbins)
  got = t_clahe.equalize_adapthist(
      torch.from_numpy(img), grid_size=grid_size, nbins=nbins).numpy()
  assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize('size,route', [
    (64, 'small'), (128, 'small'), (256, 'split'), (384, 'split')])
def test_size_classes_match_jax(size, route):
  img = _frames(size, 2, size, size)
  assert t_clahe.clahe_route(size, size, 8) == route
  want = _jax_xla(img)
  got = t_clahe.equalize_adapthist(torch.from_numpy(img)).numpy()
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= TOL


def _hold_small_against_pallas(b, h, w, g, nbins, seed=7):
  """`clahe_small`'s twin and histograms against the Pallas `clahe_fused`
  in interpret mode, on the dual-block layout that kernel takes."""
  th, tw = h // g, w // g
  img = _frames(seed, b, h, w)
  bins = np.clip((img * nbins).astype(np.int32), 0, nbins - 1)
  pad_y, pad_x = th // 2, tw // 2
  padded = np.pad(bins, ((0, 0), (pad_y, th - pad_y), (pad_x, tw - pad_x)),
                  mode='edge')
  blocks = padded.reshape(b, g + 1, th, g + 1, tw).transpose(
      0, 1, 3, 2, 4).reshape(b, (g + 1) ** 2, th * tw)
  tiles = bins.reshape(b, g, th, g, tw).transpose(0, 1, 3, 2, 4).reshape(
      b, g * g, th * tw)
  fy = ((np.arange(th, dtype=np.float32) + 0.5) / th)[:, None]
  fx = ((np.arange(tw, dtype=np.float32) + 0.5) / tw)[None, :]
  wgt = np.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx),
                  fy * fx], axis=-1).reshape(th * tw, 4)
  out_blocks = np.asarray(j_cfp.clahe_fused(
      jnp.asarray(blocks), jnp.asarray(tiles), jnp.asarray(wgt), g=g, th=th,
      tw=tw, nbins=nbins, clip_limit=0.01, interpret=True))
  want = out_blocks.reshape(b, g + 1, g + 1, th, tw).transpose(
      0, 1, 3, 2, 4).reshape(b, (g + 1) * th, (g + 1) * tw)[
          :, pad_y:pad_y + h, pad_x:pad_x + w]
  got, hist = t_cf.clahe_small(torch.from_numpy(img), 0.01, g, nbins,
                               return_hist=True)
  assert np.abs(got.numpy() - want).max() <= TOL
  # The integer tile histograms, against a direct count.
  counts = np.stack([
      np.stack([np.bincount(tiles[i, t], minlength=nbins)
                for t in range(g * g)]) for i in range(b)])
  np.testing.assert_array_equal(
      hist.numpy().reshape(b, g * g, nbins), counts)


@pytest.mark.parametrize('nbins', [256, 128])
def test_small_route_matches_pallas_fused_interpret(nbins):
  """`clahe_small`'s twin against the Pallas kernel it replaces."""
  _hold_small_against_pallas(2, 64, 64, 8, nbins)


@pytest.mark.parametrize('shape,grid,nbins', [
    ((3, 96, 160), 8, 256), ((4, 64, 64), 4, 100), ((1, 64, 64), 8, 64),
    ((2, 128, 128), 8, 256)])
def test_small_route_matches_pallas_fused_interpret_at_more_shapes(
    shape, grid, nbins):
  """Tiles of 12 x 20 pixels, a 4 x 4 grid with 100 bins, 64^2 and 128^2
  frames (the generator's size)."""
  _hold_small_against_pallas(*shape, grid, nbins, seed=sum(shape))


def test_small_route_equals_split_pair():
  """At a shape both routes accept they are the same function."""
  img = torch.from_numpy(_frames(11, 8, 128, 128))
  small, hist_small = t_cf.clahe_small(img, return_hist=True)
  hist, mapping = t_cf.clahe_hist_lut(img)
  pair = t_cf.clahe_remap(img, mapping)
  assert torch.equal(hist_small, hist)
  assert float((small - pair).abs().max()) == 0.0
  assert float((small - t_cf.clahe_reference(img)).abs().max()) == 0.0


@pytest.mark.parametrize('size,grid_size', [(100, 8), (30, 16)])
def test_padded_matches_jax(size, grid_size):
  """100^2 pads by reflection to 112^2; 30^2 at grid 16 is no larger than
  the multiple, so it pads by edge replication to 32^2."""
  img = _frames(size, 2, size, size)
  want = np.asarray(j_clahe.equalize_adapthist_padded(
      jnp.asarray(img), grid_size=grid_size, backend='xla'))
  got = t_clahe.equalize_adapthist_padded(
      torch.from_numpy(img), grid_size=grid_size).numpy()
  assert got.shape == (2, size, size)
  assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize('size,grid_size,calls', [
    (64, 8, ['small']),
    (128, 8, ['small']),
    (128, 4, ['hist_lut', 'remap']),  # 1024-pixel tiles
    (256, 8, ['hist_lut', 'remap']),
    (384, 8, ['hist_lut', 'remap']),
])
def test_routing_is_a_function_of_shape(monkeypatch, size, grid_size, calls):
  seen = []

  def spy(name):
    real = getattr(t_cf, f'clahe_{name}')

    def wrapped(*args, **kwargs):
      seen.append(name)
      return real(*args, **kwargs)

    monkeypatch.setattr(t_cf, f'clahe_{name}', wrapped)

  for name in ('small', 'hist_lut', 'remap'):
    spy(name)
  out = t_clahe.equalize_adapthist(
      torch.from_numpy(_frames(1, 1, size, size)), grid_size=grid_size)
  assert seen == calls
  assert out.shape == (1, size, size)


def test_wrappers_refuse_what_the_kernels_do_not_take():
  img = torch.zeros((1, 128, 128))
  with pytest.raises(ValueError, match='exceed'):
    t_cf.clahe_small(img, grid_size=4)  # 1024-pixel tiles
  with pytest.raises(ValueError, match='divisible'):
    t_clahe.equalize_adapthist(torch.zeros((1, 100, 100)))
  with pytest.raises(TypeError):
    t_clahe.equalize_adapthist(img.double())
  meta = torch.zeros((1, 128, 128), device='meta')
  for fn in (t_cf.clahe_small, t_cf.clahe_hist_lut):
    with pytest.raises(ValueError, match='unsupported device'):
      fn(meta)
