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
from putting_dune_torch.imaging import render as t_render
from putting_dune_torch.ops import clahe_fused
from putting_dune_torch.ops import clahe_interp
from putting_dune_torch.ops import noise_fused
from putting_dune_torch.ops import splat

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


def _splat_inputs(b, k, s, seed, device):
  """Random integer bins, weights with a masked tail, sigmas ~ S / 54."""
  rng = np.random.default_rng(seed)
  bx = rng.integers(0, s, (b, k)).astype(np.float32)
  by = rng.integers(0, s, (b, k)).astype(np.float32)
  w = rng.uniform(10.0, 200.0, (b, k)).astype(np.float32)
  w[:, k // 2:] = 0.0
  sx = rng.uniform(0.8, 1.2, b).astype(np.float32) * s / 53.75
  sy = rng.uniform(0.8, 1.2, b).astype(np.float32) * s / 53.75
  return [torch.from_numpy(a).to(device) for a in (bx, by, w, sx, sy)]


@pytest.mark.parametrize('b,k,s', [
    (100, 512, 256), (100, 512, 512), (3, 77, 128), (2, 300, 100)])
def test_splat_render_matches_twin_and_default_route(cuda, b, k, s):
  bx, by, w, sx, sy = _splat_inputs(b, k, s, 5, cuda)
  before = _build.LAUNCHES['splat_render']
  got = splat.splat_render(bx, by, w, sx, sy, image_size=s)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['splat_render'] == before + 1
  # The twin is the batched matrix product of the two factor tensors.
  want = splat.splat_render_reference(bx, by, w, sx, sy, image_size=s)
  # f32 sums of the same products in another order, then one division.
  assert float((got - want).abs().max()) <= 1e-5
  assert float(got.amax()) == 1.0


@pytest.mark.parametrize('b,k,p,v', [
    (100, 81, 1024, 256), (100, 81, 4096, 256), (100, 81, 1024, 128),
    (3, 25, 600, 1024), (2, 9, 35, 77)])
def test_clahe_interp_matches_twin(cuda, b, k, p, v):
  gen = torch.Generator(device=cuda).manual_seed(6)
  blocks = torch.randint(0, v, (b, k, p), generator=gen, device=cuda,
                         dtype=torch.int32)
  luts = torch.rand((b, k, v, 4), generator=gen, device=cuda)
  wgt = torch.rand((p, 4), generator=gen, device=cuda)
  before = _build.LAUNCHES['clahe_interp']
  got = clahe_interp.clahe_interpolate(blocks, luts, wgt)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['clahe_interp'] == before + 1
  want = clahe_interp.clahe_interpolate_reference(blocks, luts, wgt)
  # Same four products summed in the same order: 1e-6 covers a last bit.
  assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize('shape,nbins', [
    ((100, 256, 256), 256), ((8, 512, 512), 256), ((4, 128, 128), 128)])
def test_interp_route_matches_default_route(cuda, shape, nbins):
  image = _skewed(shape, 7, cuda)
  want = t_clahe.equalize_adapthist(image, nbins=nbins)
  got = t_clahe.equalize_adapthist(image, nbins=nbins, backend='interp')
  torch.cuda.synchronize()
  assert float((got - want).abs().max()) <= 2e-5


def test_new_kernels_never_call_their_twins(cuda, monkeypatch):
  def boom(*args, **kwargs):
    raise AssertionError('a plain twin ran on a CUDA tensor')

  monkeypatch.setattr(splat, 'splat_render_reference', boom)
  monkeypatch.setattr(clahe_interp, 'clahe_interpolate_reference', boom)
  bx, by, w, sx, sy = _splat_inputs(2, 64, 128, 8, cuda)
  out = splat.splat_render(bx, by, w, sx, sy, image_size=128)
  out = t_clahe.equalize_adapthist(out, backend='interp')
  torch.cuda.synchronize()
  assert bool(torch.isfinite(out).all())


def test_new_wrappers_refuse_bad_inputs(cuda):
  bx, by, w, sx, sy = _splat_inputs(2, 64, 128, 9, cuda)
  with pytest.raises(TypeError, match='bx'):
    splat.splat_render(bx.to(torch.int32), by, w, sx, sy, image_size=128)
  with pytest.raises(ValueError, match='contiguous'):
    splat.splat_render(bx.t().contiguous().t(), by, w, sx, sy,
                       image_size=128)
  with pytest.raises(ValueError, match='devices'):
    splat.splat_render(bx, by.cpu(), w, sx, sy, image_size=128)
  blocks = torch.zeros((2, 9, 64), dtype=torch.int32, device=cuda)
  luts = torch.zeros((2, 9, 256, 4), device=cuda)
  wgt = torch.zeros((64, 4), device=cuda)
  with pytest.raises(TypeError, match='blocks'):
    clahe_interp.clahe_interpolate(blocks.to(torch.int64), luts, wgt)
  with pytest.raises(ValueError, match='contiguous'):
    clahe_interp.clahe_interpolate(blocks, luts.transpose(1, 2), wgt)
  with pytest.raises(ValueError, match='devices'):
    clahe_interp.clahe_interpolate(blocks, luts, wgt.cpu())
  with pytest.raises(ValueError, match='luts'):
    clahe_interp.clahe_interpolate(blocks, luts[:, :8].contiguous(), wgt)


@pytest.mark.parametrize('shape', [
    (4, 256, 256), (2, 512, 512), (3, 200, 328), (2, 50, 37), (1, 96, 96)])
def test_noise_chain_philox_matches_twin_fed_draws_from_seeds(cuda, shape):
  b, h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(10)
  image = torch.rand(shape, generator=gen, device=cuda) ** 3
  packed = _packed(b, cuda)
  seeds = torch.randint(0, 2**62, (b,), generator=gen, device=cuda)
  before = _build.LAUNCHES['noise_chain']
  got = noise_fused.noise_chain(image, packed, seeds=seeds)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['noise_chain'] == before + 1
  draws = noise_fused.draws_from_seeds(seeds, b, h, w, cuda)
  want = noise_fused.noise_chain_reference(image, packed, draws=draws)
  # Same counters, same words, the same libm on both sides: every pixel
  # equal on the H100 this was written on. At most 1e-5 of the pixels may
  # differ, which a last-bit difference in a logarithm could cause by
  # flipping a Poisson count.
  assert int((got != want).sum()) <= 1e-5 * got.numel()
  assert bool(torch.isfinite(got).all())
  assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
  # The same seeds give the same frames; the frames do not depend on how
  # many frames share the launch.
  again = noise_fused.noise_chain(image, packed, seeds=seeds)
  assert torch.equal(got, again)


@pytest.mark.parametrize('shape', [
    (3, 200, 328), (2, 50, 37), (1, 512, 512), (300, 64, 64), (1, 7, 5),
    (1, 1024, 1024)])
def test_noise_chain_injected_at_odd_shapes_and_batches(cuda, shape):
  """Widths that are no multiple of four, rows that do not divide over a
  frame's blocks, one frame, more frames than SMs, and a frame too large
  for shared memory: all bit-equal to the twin."""
  b, h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(11)
  image = torch.rand(shape, generator=gen, device=cuda)
  packed = _packed(b, cuda)
  draws = noise_fused.sample_draws(gen, b, h, w, cuda)
  got = noise_fused.noise_chain(image, packed, draws=draws)
  want = noise_fused.noise_chain_reference(image, packed, draws=draws)
  torch.cuda.synchronize()
  assert float((got - want).abs().max()) == 0.0


@pytest.mark.parametrize('shape,grid,nbins', [
    ((16, 240, 360), 6, 256), ((16, 240, 360), 5, 100),
    ((2, 256, 256), 4, 1024), ((3, 128, 128), 8, 1024),
    ((2, 256, 256), 16, 1024), ((1, 512, 512), 8, 256),
    ((100, 512, 512), 8, 256), ((64, 128, 128), 8, 128),
    ((2, 66, 90), 3, 2), ((2, 64, 64), 1, 256)])
def test_clahe_remap_is_bit_equal_to_its_twin(cuda, shape, grid, nbins):
  """Grids other than 8, 1024 bins (the table then takes several passes),
  tiles of 16 pixels, tiles that are no multiple of 8 (one pixel a thread)
  and a single image (bands split over blocks)."""
  image = _skewed(shape, 12, cuda)
  _, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  before = _build.LAUNCHES['clahe_remap']
  got = clahe_fused.clahe_remap(image, mapping)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['clahe_remap'] == before + 1
  want = clahe_fused.remap_reference(image, mapping)
  assert float((got - want).abs().max()) == 0.0


def test_noise_and_remap_wrappers_refuse_bad_inputs(cuda):
  image = torch.zeros((2, 64, 64), device=cuda)
  packed = _packed(2, cuda)
  seeds = torch.zeros((2,), dtype=torch.int64, device=cuda)
  with pytest.raises(TypeError, match='image'):
    noise_fused.noise_chain(image.double(), packed, seeds=seeds)
  with pytest.raises(ValueError, match='contiguous'):
    noise_fused.noise_chain(image.transpose(1, 2), packed, seeds=seeds)
  with pytest.raises(ValueError, match='one device'):
    noise_fused.noise_chain(image, packed.cpu(), seeds=seeds)
  with pytest.raises(ValueError, match='seeds'):
    noise_fused.noise_chain(image, packed, seeds=seeds.cpu())
  with pytest.raises(TypeError, match='seeds'):
    noise_fused.noise_chain(image, packed, seeds=seeds.to(torch.int32))
  with pytest.raises(ValueError, match='needs draws'):
    noise_fused.noise_chain(image, packed)
  mapping = torch.zeros((2, 8, 8, 256), device=cuda)
  with pytest.raises(TypeError, match='image'):
    clahe_fused.clahe_remap(image.double(), mapping)
  with pytest.raises(TypeError, match='mapping'):
    clahe_fused.clahe_remap(image, mapping.double())
  with pytest.raises(ValueError, match='contiguous'):
    clahe_fused.clahe_remap(image.transpose(1, 2), mapping)
  with pytest.raises(ValueError, match='different devices'):
    clahe_fused.clahe_remap(image, mapping.cpu())
  with pytest.raises(ValueError, match='nbins'):
    clahe_fused.clahe_remap(image, torch.zeros((2, 8, 8, 2048), device=cuda))


@pytest.mark.parametrize('shape,grid,nbins', [
    ((100, 512, 512), 8, 256), ((128, 256, 256), 8, 256),
    ((4, 264, 328), 8, 256), ((8, 256, 256), 8, 100),
    ((2, 256, 256), 4, 1024), ((64, 128, 128), 8, 128),
    ((16, 240, 360), 6, 256), ((2, 66, 90), 3, 2)])
def test_clahe_hist_lut_is_bit_equal_to_the_order_exact_version(
    cuda, shape, grid, nbins):
  """Tiles of 33 x 41 pixels (one float a lane), 100 and 1024 bins, a 6 x 6
  grid and 2 bins: histograms equal to the twin's, mappings bit-equal to
  the sums in the kernel's order."""
  image = _skewed(shape, 13, cuda)
  before = _build.LAUNCHES['clahe_hist_lut']
  hist, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['clahe_hist_lut'] == before + 1
  want_hist, want_mapping = clahe_fused.hist_lut_order_exact(
      image, grid, 0.01, nbins)
  assert torch.equal(hist, want_hist)
  assert torch.equal(
      hist, clahe_fused.hist_lut_reference(image, grid, 0.01, nbins)[0])
  assert float((mapping - want_mapping).abs().max()) == 0.0


@pytest.mark.parametrize('shape,grid,nbins', [
    ((8, 128, 128), 8, 256), ((16, 128, 128), 8, 128), ((4, 64, 64), 4, 100),
    ((2, 32, 32), 2, 1024)])
def test_clahe_small_is_bit_equal_to_the_split_pair(cuda, shape, grid, nbins):
  """Both routes run clahe::tile_mapping: the one-launch kernel's frames
  are the pair's bit for bit, and both are the remap of the order-exact
  mapping."""
  image = _skewed(shape, 14, cuda)
  small, hist = clahe_fused.clahe_small(image, 0.01, grid, nbins,
                                        return_hist=True)
  pair_hist, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  pair = clahe_fused.clahe_remap(image, mapping)
  _, exact = clahe_fused.hist_lut_order_exact(image, grid, 0.01, nbins)
  torch.cuda.synchronize()
  assert torch.equal(hist, pair_hist)
  assert float((small - pair).abs().max()) == 0.0
  assert float((small - clahe_fused.remap_reference(image, exact))
               .abs().max()) == 0.0


@pytest.mark.parametrize('shape,grid,nbins', [
    ((1, 128, 128), 8, 256), ((7, 128, 128), 8, 256),
    ((3, 96, 96), 8, 256), ((3, 96, 160), 8, 256), ((3, 144, 240), 12, 256),
    ((2, 256, 256), 16, 128), ((2, 128, 256), 8, 256), ((2, 120, 72), 8, 100),
    ((1, 1024, 8), 8, 256), ((2, 64, 64), 4, 1024), ((5, 16, 16), 1, 256)])
def test_clahe_small_more_shapes_are_bit_equal_to_the_split_pair(
    cuda, shape, grid, nbins):
  """Batch 1 and an odd batch; tiles 12 pixels wide and 12 x 20; grids of
  12 and 16 (the block's 16 warps take several tiles each); 512-pixel
  tiles; odd tile widths and 1-pixel-wide tiles (one float a lane); 1024
  bins; one tile. Histograms equal to the pair's and the twin's, frames
  max |d| 0 against the pair."""
  image = _skewed(shape, 16, cuda)
  before = _build.LAUNCHES['clahe_small']
  small, hist = clahe_fused.clahe_small(image, 0.01, grid, nbins,
                                        return_hist=True)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['clahe_small'] == before + 1
  pair_hist, mapping = clahe_fused.clahe_hist_lut(image, grid, 0.01, nbins)
  pair = clahe_fused.clahe_remap(image, mapping)
  torch.cuda.synchronize()
  assert torch.equal(hist, pair_hist)
  assert torch.equal(
      hist, clahe_fused.hist_lut_reference(image, grid, 0.01, nbins)[0])
  assert float((small - pair).abs().max()) == 0.0
  assert torch.equal(small, clahe_fused.clahe_small(image, 0.01, grid, nbins))


@pytest.mark.parametrize('b,k,s,sigma_scale', [
    (100, 512, 256, 1.0), (100, 512, 512, 1.0), (1, 77, 200, 1.0),
    (4, 64, 128, 8.0), (2, 40, 1024, 1.0), (300, 64, 128, 1.0),
    (3, 5, 1, 1.0)])
def test_splat_render_is_bit_equal_to_the_atom_order_version(
    cuda, b, k, s, sigma_scale):
  """The main shapes; one frame with K not a multiple of 32; a radius (~38
  rows) above a band's 8; frames wider than a chunk (1024); more images
  than clusters on the card; a one-pixel frame."""
  bx, by, w, sx, sy = _splat_inputs(b, k, s, 15, cuda)
  sx, sy = sx * sigma_scale, sy * sigma_scale
  before = _build.LAUNCHES['splat_render']
  got = splat.splat_render(bx, by, w, sx, sy, image_size=s)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['splat_render'] == before + 1
  want = splat.splat_render_atom_order(bx, by, w, sx, sy, image_size=s)
  assert float((got - want).abs().max()) == 0.0
  assert float(got.amax()) == 1.0


def _pixel_env(batch, device):
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  exp = registry.create_eval_experiment('ppo_simple_images_tf')
  return run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=batch,
      image_size=512, device=device)


def test_auto_splat_on_the_card_is_the_kernel(cuda):
  """'auto' on the env's atom windows at (64, 512 atoms, 512^2): one
  `splat_render` launch, bit-equal to the atom-order sum and to the
  batched matrix product (both an f32 fused multiply-add an atom)."""
  from putting_dune_torch import simulator as simulator_lib
  from putting_dune_torch.env import env as env_lib

  env = _pixel_env(64, cuda)
  state, _ = env.reset(env_lib.make_generator(4, cuda))
  fov = state.sim.fov
  window = simulator_lib.atom_window(env.lattice, state.sim.material, fov,
                                     env.config.sim.window_capacity)
  imaging = state.sim.imaging
  args = (window, fov, imaging.intensity_exponent)
  kwargs = dict(image_size=512, blur_amount=imaging.blur_amount)
  assert tuple(window.positions.shape) == (64, 512, 2)
  before = _build.LAUNCHES['splat_render']
  got = t_render.render_clean_image(*args, backend='auto', **kwargs)
  torch.cuda.synchronize()
  assert _build.LAUNCHES['splat_render'] == before + 1
  operands = [t.contiguous() for t in t_render._splat_inputs(
      window, fov, imaging.intensity_exponent, 512, imaging.blur_amount)]
  want = splat.splat_render_atom_order(*operands, image_size=512)
  assert float((got - want).abs().max()) == 0.0
  bmm = t_render.render_clean_image(*args, backend='bmm', **kwargs)
  assert torch.equal(got, bmm)
  assert _build.LAUNCHES['splat_render'] == before + 1


def test_env_step_observations_do_not_move_with_the_splat_route(
    cuda, monkeypatch):
  """One pixel env step at B 8 from one state and one generator seed, as
  shipped and with the splat forced onto the batched matrix product: the
  clean frames are bit-equal, so the observations are too."""
  import functools

  from putting_dune_torch.env import env as env_lib

  env = _pixel_env(8, cuda)
  state, _ = env.reset(env_lib.make_generator(5, cuda))
  action = torch.zeros((8,) + env.action_spec().shape, device=cuda)

  def step():
    before = _build.LAUNCHES['splat_render']
    _, ts = env.step(state, action, env_lib.make_generator(6, cuda))
    torch.cuda.synchronize()
    return ts.observation['image'], _build.LAUNCHES['splat_render'] - before

  shipped, launched = step()
  assert launched == 1
  monkeypatch.setattr(t_render, 'render_clean_image', functools.partial(
      t_render.render_clean_image, backend='bmm'))
  forced, launched = step()
  assert launched == 0
  assert torch.equal(shipped, forced)


def _toy_update_on(device, seed=0, mesh=None):
  """One PPO update on the toy env (tests/torch_toy_env.py) on `device`,
  from fixed parameters with injected noises and permutations; over `mesh`
  when given."""
  import torch_toy_env
  from putting_dune_torch.agents import ppo

  config = ppo.PPOConfig(hidden=(64, 64), rollout_length=8, num_epochs=2,
                         num_minibatches=4, reward_shaping_coef=0.05)
  env = torch_toy_env.ToyEnv(torch_toy_env.starts(256, seed=seed), device)
  gen = torch.Generator().manual_seed(seed)
  template = ppo.flax_init_(ppo.ActorCritic(2, config.hidden, (), obs_dim=6),
                            gen)
  noise = torch.randn((1, 8, 256, 2), generator=gen)
  perms = torch.stack([torch.randperm(8 * 256, generator=gen)
                       for _ in range(2)])[None]
  init_carry, run_updates = ppo.make_train_fns(env, config, mesh)
  carry = init_carry(seed, ppo.actor_critic_to_flax(template))
  carry, metrics = run_updates(carry, 1, noise=noise.to(device),
                               perms=perms.to(device))
  return (ppo.actor_critic_to_flax(carry.model),
          {k: float(v[0]) for k, v in metrics.items()})


def test_ppo_update_on_cuda_matches_cpu(cuda):
  import torch_toy_env

  got_params, got_metrics = _toy_update_on(cuda)
  want_params, want_metrics = _toy_update_on('cpu')
  assert torch_toy_env.max_tree_diff(got_params, want_params) <= 1e-4
  for name, value in want_metrics.items():
    assert abs(got_metrics[name] - value) <= 1e-4, name


def _toy_dagger_iteration_on(device, seed=0):
  import torch_toy_env
  from putting_dune_torch.agents import distill
  from putting_dune_torch.agents import eval_agent
  from putting_dune_torch.agents import ppo

  config = distill.DistillConfig(num_iterations=1, rollout_length=8,
                                 sgd_steps_per_iteration=16,
                                 minibatch_size=512, hidden=(64, 64),
                                 output_scale=1.0)
  env = torch_toy_env.ToyEnv(torch_toy_env.starts(256, seed=seed), device)
  gen = torch.Generator().manual_seed(seed)
  template = ppo.flax_init_(distill.student_module(config, 6), gen)
  mix = torch.rand((8, 256, 1), generator=gen)
  indices = torch.randint(0, 8 * 256, (16, 512), generator=gen)
  init_carry, run_iteration = distill.make_distill_fns(
      env, None, config, teacher=torch_toy_env.teacher)
  carry = init_carry(seed, eval_agent.policy_to_flax(template))
  carry, metrics = run_iteration(carry, 0.5, mix=mix.to(device),
                                 indices=indices.to(device))
  return eval_agent.policy_to_flax(carry.model), float(metrics['loss'])


def test_dagger_iteration_on_cuda_matches_cpu(cuda):
  import torch_toy_env

  got_params, got_loss = _toy_dagger_iteration_on(cuda)
  want_params, want_loss = _toy_dagger_iteration_on('cpu')
  assert torch_toy_env.max_tree_diff(got_params, want_params) <= 1e-4
  assert abs(got_loss - want_loss) <= 1e-4


def _pixel_learn_on(device, seed=0):
  """One update's gradient steps of an image actor-critic on `device`, on
  a fixed made-up rollout: the convolutions' backward runs in full
  float32 on the card (PPOTrainer.learn), so it agrees with the CPU."""
  import types

  from putting_dune_torch.agents import ppo

  t, b, size = 4, 32, 32
  shape = types.SimpleNamespace
  env = types.SimpleNamespace(
      batch_size=b, device=torch.device(device),
      action_spec=lambda: shape(shape=(2,)),
      observation_spec=lambda: {'image': shape(shape=(size, size, 1)),
                                'goal_delta_angstroms': shape(shape=(2,))})
  config = ppo.PPOConfig(rollout_length=t, num_epochs=2, num_minibatches=2,
                         hidden=(32,), conv_features=(8, 16, 32))
  gen = torch.Generator().manual_seed(seed)
  model = ppo.flax_init_(ppo.ActorCritic(2, (32,), (8, 16, 32), size), gen)
  traj = {
      'obs': {'image': torch.rand((t, b, size, size, 1), generator=gen),
              'goal_delta_angstroms': torch.randn((t, b, 2), generator=gen)},
      'action': torch.randn((t, b, 2), generator=gen),
      'logprob': -2.0 + 0.1 * torch.randn((t, b), generator=gen),
      'value': torch.randn((t, b), generator=gen),
      'reward': (torch.rand((t, b), generator=gen) < 0.1).float(),
      'discount': torch.full((t, b), 0.99),
      'next_is_first': torch.rand((t, b), generator=gen) < 0.05,
  }
  last_value = torch.randn((b,), generator=gen)
  perms = torch.stack([torch.randperm(t * b, generator=gen)
                       for _ in range(2)])
  model = model.to(device)
  to = lambda x: ({k: v.to(device) for k, v in x.items()}
                  if isinstance(x, dict) else x.to(device))
  carry = ppo.TrainCarry(model, ppo.make_optimizer(model, 3e-4), None, None,
                         torch.Generator(device=device))
  metrics = ppo.PPOTrainer(env, config).learn(
      carry, {k: to(v) for k, v in traj.items()}, last_value.to(device),
      perms.to(device))
  return ppo.actor_critic_to_flax(model), float(metrics['loss'])


def test_pixel_ppo_gradient_steps_on_cuda_match_cpu(cuda):
  import torch_toy_env

  got_params, got_loss = _pixel_learn_on(cuda)
  want_params, want_loss = _pixel_learn_on('cpu')
  assert torch_toy_env.max_tree_diff(got_params, want_params) <= 1e-4
  assert abs(got_loss - want_loss) <= 1e-4


def test_image_aligner_on_the_card_matches_the_cpu(cuda):
  """The shipped aligner on CUDA (clahe_small, full-f32 convolutions)
  against the port on the CPU: drifts within 1e-4 A, equal detections."""
  from putting_dune_torch import microscope_agent
  from putting_dune_torch.image_alignment import inference

  on_card = inference.ImageAligner.from_checkpoint(device=cuda)
  on_cpu = inference.ImageAligner.from_checkpoint(device='cpu')
  _build.reset_launches()
  sequence, _ = microscope_agent.drifting_sequence(11, 6, device='cpu')
  for obs in sequence:
    a_grid, a_drift, a_probs = on_card(obs.image, obs.fov)
    b_grid, b_drift, b_probs = on_cpu(obs.image, obs.fov)
    assert np.abs(a_drift - b_drift).max() <= 1e-4
    assert np.abs(a_probs - b_probs).max() <= 1e-3
    assert sorted(map(tuple, np.round(a_grid.atom_positions, 9))) == sorted(
        map(tuple, np.round(b_grid.atom_positions, 9)))
  assert _build.LAUNCHES['clahe_small'] == 6


def test_atom_detector_on_the_card_matches_the_cpu(cuda):
  from putting_dune_torch import lattice
  from putting_dune_torch.agents import vision_planner
  from putting_dune_torch.atom_detection import data
  from putting_dune_torch.atom_detection import inference

  on_card = inference.AtomDetector.from_checkpoint(
      vision_planner.SHIPPED_DETECTOR_DIR, device=cuda)
  on_cpu = inference.AtomDetector.from_checkpoint(
      vision_planner.SHIPPED_DETECTOR_DIR, device='cpu')
  gen = torch.Generator(device=cuda).manual_seed(0)
  batch = data.sample_batch(gen, lattice.make_lattice(50, cuda), batch_size=8,
                            image_size=256, noisy=True)
  equal = 0
  for image in batch['image'].cpu().numpy():
    a, b = on_card(image), on_cpu(image)
    equal += sorted(map(tuple, np.round(a.atom_positions, 9))) == sorted(
        map(tuple, np.round(b.atom_positions, 9)))
  assert equal >= 7


def _one_train_step(module, config, make_batch, step, device):
  """(metrics, gradients by parameter) of one train step of a trainer on
  `device`, from the same initial params and batch. The step must have
  moved every parameter by optax's first AdamW update on these gradients,
  p - lr (g / (|g| + eps) + 1e-4 p), within 1e-3 lr plus 2^-22 |p|."""
  state = module.create_state(config, device=device)
  before = {k: p.detach().double() for k, p in
            state.model.named_parameters()}
  batch = {k: v.to(device) for k, v in make_batch().items()}
  _, metrics = step(state, batch)
  lr = config.learning_rate
  for key, p in state.model.named_parameters():
    p0, g = before[key], p.grad.double()
    want = p0 - lr * (g / (g.abs() + 1e-8) + 1e-4 * p0)
    err = (p.detach().double() - want).abs()
    assert bool((err <= 1e-3 * lr + 2.0**-22 * p0.abs()).all()), (
        device, key, float(err.max()) / lr)
  return ({k: float(v) for k, v in metrics.items()},
          {k: p.grad.cpu() for k, p in state.model.named_parameters()})


@pytest.mark.parametrize('trainer', ['detector', 'aligner', 'graph'])
def test_one_train_step_on_the_card_matches_the_cpu(cuda, trainer):
  """Full-f32 train steps (TF32 off) on the card and on the CPU, the same
  params and batch: metrics within 1e-4, gradients within 1e-4 of each
  leaf's largest, and on each device the parameters moved by the first
  AdamW update on that device's gradients. (That update is about
  lr * sign(g), so the updated params of a near-zero gradient may differ
  between the devices by up to 2 lr.)"""
  from putting_dune_torch import lattice
  from putting_dune_torch.atom_detection import data as det_data
  from putting_dune_torch.atom_detection import train as det_train
  from putting_dune_torch.graph_alignment import data as graph_data
  from putting_dune_torch.graph_alignment import train as graph_train
  from putting_dune_torch.image_alignment import data as align_data
  from putting_dune_torch.image_alignment import train as align_train

  lat = lattice.make_lattice(20, 'cpu')
  gen = torch.Generator().manual_seed(3)
  if trainer == 'detector':
    module = det_train
    config = det_train.Config(workdir='', features=(8, 16, 32),
                              image_size=64)
    batch = det_data.sample_batch(gen, lat, batch_size=4, image_size=64,
                                  noisy=True)
    step = lambda s, b: det_train.train_step(s, b, (0.2, 1.0, 10.0))  # noqa: E731
  elif trainer == 'aligner':
    module = align_train
    config = align_train.Config(workdir='', features=(8, 16), image_size=32,
                                num_frames=3)
    batch = align_data.sample_stack(gen, lat, batch_size=4, image_size=32,
                                    num_frames=3, registration_noise=0.3)
    step = lambda s, b: align_train.train_step(s, b, 1.0, 3, False)  # noqa: E731
  else:
    module = graph_train
    config = graph_train.Config(workdir='', width=32, num_layers=2, k=4,
                                capacity=64)
    batch = graph_data.sample_batch(gen, lat, batch_size=4, capacity=64)
    step = lambda s, b: graph_train.train_step(s, b)  # noqa: E731
  got = _one_train_step(module, config, lambda: batch, step, cuda)
  want = _one_train_step(module, config, lambda: batch, step, 'cpu')
  for key in want[0]:
    assert abs(got[0][key] - want[0][key]) <= 1e-4, key
  for key, g in want[1].items():
    bound = 1e-4 * float(g.abs().max())
    assert float((got[1][key] - g).abs().max()) <= bound, key


def test_world_one_nccl_ppo_update_is_the_unsharded_update(cuda):
  import torch_toy_env
  from putting_dune_torch.parallel import mesh as mesh_lib

  want_params, want_metrics = _toy_update_on(cuda)
  mesh_lib.initialize_distributed(f'localhost:{mesh_lib.free_port()}', 1, 0,
                                  device=cuda)
  try:
    mesh = mesh_lib.make_mesh(device=cuda)
    assert mesh.distributed and torch.distributed.get_backend() == 'nccl'
    got_params, got_metrics = _toy_update_on(cuda, mesh=mesh)
  finally:
    mesh_lib.shutdown()
  assert torch_toy_env.max_tree_diff(got_params, want_params) <= 1e-6
  for name, value in want_metrics.items():
    assert abs(got_metrics[name] - value) <= 1e-6, name


def test_rendered_eval_frame_round_trips_through_gif_and_png(cuda, tmp_path):
  from putting_dune_torch import eval_lib
  from putting_dune_torch import plotting_utils
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers
  from putting_dune_torch.env import env as env_lib
  from putting_dune_torch.io import gif
  from putting_dune_torch.io import png

  exp = registry.create_eval_experiment('ppo_simple_images_tf')
  env = run_helpers.create_batched_env(
      exp.get_adapters_and_goal, exp.get_simulator_config, batch_size=2,
      device=cuda)
  state, ts = env.reset(env_lib.make_generator(0, cuda))
  assert ts.observation['image'].is_cuda
  pose = [x.cpu().numpy()[None] for x in eval_lib.video_pose(state, 2)]
  video = dict(zip(('si', 'offset', 'theta', 'goal'), pose))
  positions, numbers, goal = eval_lib.video_scenes(env.lattice, video, 1, 1)
  clip = plotting_utils.generate_video_from_trajectory(
      positions, numbers, goal_position=goal)
  frame = clip.frames[0]
  assert frame.shape == (500, 500, 3) and frame.std() > 0
  decoded = gif.decode(clip.to_bytes())
  assert decoded.count == 1
  np.testing.assert_array_equal(decoded.frames[0], frame)
  np.testing.assert_array_equal(png.imdecode(png.imencode(frame))[..., ::-1],
                                frame)


# --- the classical learners on the card -----------------------------------------

LEARNERS = ('sklearn_mlp', 'knn', 'gp', 'random_forest', 'svm')
CLASSIFIER_FIXTURES = (
    __import__('pathlib').Path(__file__).resolve().parent / 'data'
    / 'torch_classifiers')


@pytest.mark.parametrize('learner', LEARNERS + ('ensemble',))
def test_jax_learner_files_predict_on_the_card(cuda, learner):
  from putting_dune_torch.classifiers import joblib_io

  q = np.load(CLASSIFIER_FIXTURES / 'queries.npy')
  model = joblib_io.load(str(CLASSIFIER_FIXTURES / f'{learner}.joblib'),
                         device=cuda)
  got = model.predict_proba_tensor(q)
  assert got.device.type == 'cuda' and got.dtype == torch.float64
  want = np.load(CLASSIFIER_FIXTURES / f'{learner}_proba.npy')
  assert float(np.abs(got.cpu().numpy() - want).max()) <= 1e-9


@pytest.mark.parametrize('learner', LEARNERS)
def test_classical_learners_fit_on_the_card_as_on_the_cpu(cuda, learner):
  from putting_dune_torch.pipeline import train_rate_learner as t_trl

  rng = np.random.default_rng(0)
  x = rng.normal(size=(300, 5)).astype(np.float32)
  x[:, :2] = (0.1, 60.0)
  y = (x[:, 3] > 0).astype(np.int32) + 2 * (x[:, 4] > 0.5)
  q = rng.normal(size=(200, 5))
  kwargs = {} if learner in ('knn', 'gp') else {'random_state': 0}
  probs = []
  for device in ('cpu', cuda):
    args = t_trl.Args(source_path='', workdir='', epochs=100, device=device)
    model = t_trl.get_sklearn_classifier(learner, args, **kwargs).fit(x, y)
    probs.append(model.predict_proba(q))
  tol = 1e-3 if learner == 'svm' else 1e-6
  assert float(np.abs(probs[0] - probs[1]).max()) <= tol


SAVED_MODEL_FIXTURES = (
    __import__('pathlib').Path(__file__).resolve().parent / 'data'
    / 'torch_saved_models')


@pytest.mark.parametrize('name', ('mlp_policy', 'rate_predictor',
                                  'atom_detector', 'image_aligner'))
def test_jax_saved_models_run_on_the_card(cuda, name):
  """The committed JAX exports through the port's loader on the card:
  outputs on `cuda`, JAX's recorded outputs within the JAX test's
  tolerances."""
  from putting_dune_torch.io import tf_export

  root = SAVED_MODEL_FIXTURES / name
  model = tf_export.load_tf_saved_model(str(root / 'saved_model'),
                                        device=cuda)
  out = model(np.load(root / 'input.npy'))
  out = out if isinstance(out, tuple) else (out,)
  rtol, atol = ((1e-3, 1e-4) if name in ('atom_detector', 'image_aligner')
                else (1e-5, 1e-5))
  for i, got in enumerate(out):
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(),
                               np.load(root / f'output_{i}.npy'),
                               rtol=rtol, atol=atol)


def test_port_export_round_trips_on_the_card(cuda, tmp_path):
  """A UNet exported from the card and reloaded there computes what the
  module does, in full float32."""
  from putting_dune_torch.atom_detection import model as det_model
  from putting_dune_torch.io import stablehlo
  from putting_dune_torch.io import tf_export

  torch.manual_seed(0)
  module = det_model.UNet(features=(8, 16)).to(cuda).eval()
  tf_export.export_tf_saved_model(module, (1, 64, 64, 1), str(tmp_path / 'm'),
                                  input_name='image')
  loaded = tf_export.load_tf_saved_model(str(tmp_path / 'm'), device=cuda)
  x = torch.randn(1, 64, 64, 1, device=cuda)
  with torch.no_grad(), stablehlo.full_float32():
    want = module(x)
  torch.testing.assert_close(loaded(x), want, rtol=1e-4, atol=1e-5)


TF_GRAPH_FIXTURES = (
    __import__('pathlib').Path(__file__).resolve().parent / 'data'
    / 'torch_tf_graphs')
TF_GRAPH_NAMES = sorted(
    __import__('json').loads((TF_GRAPH_FIXTURES / 'index.json').read_text())
    ['fixtures'])


@pytest.mark.parametrize('name', TF_GRAPH_NAMES)
def test_tf_op_graphs_run_on_the_card(cuda, name):
  """The committed graphs of TF ops (jax2tf's pre-native `xla` and
  `plain` forms) through the port's loader on the card: outputs on
  `cuda`, TF's recorded outputs within tests/test_torch_tf_graphs.py's
  tolerances."""
  import json

  from putting_dune_torch.io import tf_export

  root = TF_GRAPH_FIXTURES / name
  keys = json.loads((TF_GRAPH_FIXTURES / 'index.json').read_text())[
      'fixtures'][name]['inputs']
  x = ({k: np.load(root / f'input_{k}.npy') for k in keys} if keys
       else np.load(root / 'input.npy'))
  model = tf_export.load_tf_saved_model(str(root / 'saved_model'),
                                        device=cuda)
  out = model(x)
  out = out if isinstance(out, tuple) else (out,)
  rtol, atol = ((1e-3, 1e-4) if name.startswith(('atom_detector',
                                                 'image_aligner'))
                else (1e-5, 1e-6) if name.startswith('rate_predictor')
                else (1e-5, 1e-5))
  for i, got in enumerate(out):
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(),
                               np.load(root / f'output_{i}.npy'),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize('experiment_name', [
    'ppo_simple_images_tf', 'vision_planner_simple_rates'])
def test_every_host_sync_of_a_loop_step_has_a_span(cuda, experiment_name):
  """One loop step of the pixel policy's and of the vision planner's
  batched evaluation (its reset, one policy call and env step, and the
  read of the results) at batch 8 and the 512^2 render: under
  `set_sync_debug_mode('warn')` it raises as many synchronizing-operation
  warnings as its trace has `sync.*` spans, so that every host sync on the
  path is named."""
  import warnings

  from putting_dune_torch import eval as eval_cli
  from putting_dune_torch import eval_lib
  from putting_dune_torch import registry
  from putting_dune_torch import run_helpers

  experiment = registry.create_eval_experiment(experiment_name)
  policy = eval_cli.policy_for_agent(experiment.get_policy(
      experiment.get_adapters_and_goal(), cuda))
  env = run_helpers.create_batched_env(
      experiment.get_adapters_and_goal, experiment.get_simulator_config,
      batch_size=8, image_size=512, device=cuda)
  seeds = list(range(8))
  eval_lib.evaluate_batched(env, policy, seeds, max_steps=2)
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      torch.cuda.set_sync_debug_mode('warn')
      try:
        eval_lib.evaluate_batched(env, policy, seeds, max_steps=1)
      finally:
        torch.cuda.set_sync_debug_mode(0)
  syncs = [f'{w.filename}:{w.lineno}' for w in caught
           if 'called a synchronizing' in str(w.message)]
  # The host's spans; the profiler also lists each on the device's
  # timeline.
  spans = [e.name for e in prof.events() if e.name.startswith('sync.')
           and e.device_type == torch.autograd.DeviceType.CPU]
  assert syncs
  assert len(syncs) == len(spans), (syncs, spans)
