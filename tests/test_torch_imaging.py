"""Port parity for the imaging path: noise chain, CLAHE, render, resize.

The noise chain's plain twin is held element-wise to the JAX package's
`chain_from_uniforms` on the same injected numpy draws, and in
distribution to `apply_chain_reference` with generator draws. The CLAHE
twin is held element-wise to the JAX XLA path on the CPU, and to the
Pallas natural-layout route in interpret mode (bf16 LUTs there, hence the
looser bound). These are the CPU paths of the CUDA kernels' wrappers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import simulator as t_sim
from putting_dune_torch import structures as t_struct
from putting_dune_torch.imaging import clahe as t_clahe
from putting_dune_torch.imaging import params as t_params
from putting_dune_torch.imaging import render as t_render
from putting_dune_torch.ops import clahe_fused as t_cf
from putting_dune_torch.ops import noise_fused as t_nf
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import simulator as j_sim
from putting_dune_tpu.imaging import clahe as j_clahe
from putting_dune_tpu.imaging import params as j_params
from putting_dune_tpu.imaging import render as j_render
from putting_dune_tpu.ops import clahe_fused_pallas as j_cfp
from putting_dune_tpu.ops import noise_fused_pallas as j_nf

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


def _numpy_draws(rng, b, h, w):
  u = lambda *s: rng.uniform(1e-7, 1.0, s).astype(np.float32)  # noqa: E731
  n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
  return {
      'u_pois': u(b, h, w), 'z_pois': n(b, h, w), 'u_sp': u(b, h, w),
      'u_un': u(b, h, w), 'u_ex': u(b, h, w), 'z_gauss': n(b, h, w),
      'u_row': u(b, h), 'z_row': n(b, h),
  }


def _packed(rng, b):
  p = np.zeros((b, 8), np.float32)
  # Poisson multipliers on both sides of the lambda=4 inversion switch.
  p[:, 0] = rng.exponential(size=b) * 15 + 1
  p[:, 1] = rng.uniform(0, 5, b)
  p[:, 2] = rng.uniform(0, 0.05, b)
  p[:, 3] = rng.uniform(0.7, 1.3, b)
  p[:, 4] = rng.uniform(0, 0.2, b)
  p[:, 5] = rng.uniform(0, 0.2, b)
  p[:, 6] = rng.uniform(0, 5e-3, b)
  return p


def _jax_chain(image, packed, draws):
  jdraws = {k: jnp.asarray(v) for k, v in draws.items()}
  jdraws['u_row'] = jdraws['u_row'][..., None]
  jdraws['z_row'] = jdraws['z_row'][..., None]

  def one(img, prm, drw):
    params = {name: prm[j] for j, name in enumerate(j_nf.PARAM_FIELDS)}
    return j_nf.chain_from_uniforms(img, params, drw)

  return np.asarray(jax.vmap(one)(jnp.asarray(image), jnp.asarray(packed),
                                  jdraws))


@pytest.mark.parametrize('shape', [(4, 64, 64), (2, 128, 256)])
def test_noise_twin_matches_chain_from_uniforms(shape):
  rng = np.random.default_rng(sum(shape))
  b, h, w = shape
  image = rng.uniform(0, 1, shape).astype(np.float32)
  packed = _packed(rng, b)
  draws = _numpy_draws(rng, b, h, w)
  want = _jax_chain(image, packed, draws)
  got = t_nf.noise_chain(_t(image), _t(packed),
                         draws={k: _t(v) for k, v in draws.items()}).numpy()
  assert np.abs(got - want).max() <= 1e-5


def test_noise_roll_rows_is_exact():
  rng = np.random.default_rng(3)
  img = rng.random((2, 8, 256), np.float32)
  shifts = np.array([[0, 1, 17, 63, 64, 100, 126, 127],
                     [127, 5, 0, 300, 2, 255, 128, 9]])
  got = t_nf.roll_rows(_t(img), _t(shifts)).numpy()
  want = np.stack([
      np.stack([np.roll(img[b, y], min(shifts[b, y], 127))
                for y in range(8)]) for b in range(2)])
  np.testing.assert_array_equal(got, want)
  # The JAX package's roll on the same rows and (clipped) shifts.
  jgot = np.asarray(j_nf._roll_rows(
      jnp.asarray(img[0]), jnp.asarray(np.minimum(shifts[0], 127)[:, None]),
      max_shift=127))
  np.testing.assert_array_equal(got[0], jgot)


def test_noise_row_shifts_in_chain_are_exact_rolls():
  # With every other stage off and a large Poisson multiplier, the chain
  # is renorm + roll; the twin's rows must be exact rolls of the JAX
  # output's source rows.
  rng = np.random.default_rng(5)
  b, h, w = 2, 16, 128
  image = rng.uniform(0.2, 1, (b, h, w)).astype(np.float32)
  packed = np.zeros((b, 8), np.float32)
  packed[:, 0] = 1e8
  packed[:, 1] = 3.0
  packed[:, 3] = 1.0
  draws = _numpy_draws(rng, b, h, w)
  want = _jax_chain(image, packed, draws)
  got = t_nf.noise_chain(_t(image), _t(packed),
                         draws={k: _t(v) for k, v in draws.items()}).numpy()
  assert np.abs(got - want).max() <= 1e-5


def test_noise_generator_draws_match_jax_in_distribution():
  b, h, w = 4, 128, 128
  image = np.full((b, h, w), 0.5, np.float32)
  image[:, 0, 0] = 1.0
  packed = np.zeros((b, 8), np.float32)
  packed[:, 0] = 1e8
  packed[:, 2] = 0.2
  packed[:, 3] = 1.0
  packed[:, 6] = 1e-3
  want = np.asarray(j_nf.apply_chain_reference(
      jax.random.PRNGKey(2), jnp.asarray(image), jnp.asarray(packed)))
  got = t_nf.noise_chain(_t(image), _t(packed),
                         gen=torch.Generator().manual_seed(2)).numpy()
  for out in (want, got):
    assert abs((out > 0.9).mean() - 0.1) < 0.01
    assert abs((out < 0.1).mean() - 0.1) < 0.01
  mid_w = want[(want > 0.2) & (want < 0.8)]
  mid_g = got[(got > 0.2) & (got < 0.8)]
  assert abs(mid_w.mean() - mid_g.mean()) < 2e-3
  assert abs(mid_w.std() - mid_g.std()) < 2e-3


def test_noise_generator_draws_full_chain_moments():
  # One parameter set (both Poisson regimes across the frame) for 128
  # frames: per-frame mean and std are iid across frames in each package,
  # and their laws must agree (each frame's max-renorms make them vary).
  rng = np.random.default_rng(7)
  b, h, w = 128, 32, 32
  image = np.broadcast_to(rng.uniform(0, 1, (h, w)).astype(np.float32),
                          (b, h, w)).copy()
  packed = np.repeat(_packed(rng, 1), b, axis=0)
  packed[:, 0] = 8.0
  want = np.asarray(j_nf.apply_chain_reference(
      jax.random.PRNGKey(3), jnp.asarray(image), jnp.asarray(packed)))
  got = t_nf.noise_chain(_t(image), _t(packed),
                         gen=torch.Generator().manual_seed(3)).numpy()
  for stat in (np.mean, np.std):
    sw, sg = stat(want, axis=(1, 2)), stat(got, axis=(1, 2))
    se = np.sqrt((sw.var() + sg.var()) / b)
    assert abs(sw.mean() - sg.mean()) < 4.5 * se, stat
    assert scipy.stats.ks_2samp(sw, sg).pvalue > 1e-3, stat


def test_pack_params_rejects_large_jitter():
  gen = torch.Generator().manual_seed(0)
  params = t_params.sample_imaging_params(gen, 4, device='cpu')
  packed = t_nf.pack_params(params, 4)
  assert packed.shape == (4, 8)
  np.testing.assert_array_equal(packed[:, 1].numpy(),
                                params.jitter_rate.numpy())
  bad = dataclasses.replace(params, jitter_rate=torch.full((4,), 41.0))
  with pytest.raises(ValueError, match='jitter_rate'):
    t_nf.pack_params(bad, 4)


@pytest.mark.parametrize('shape,grid', [
    ((2, 64, 64), 2), ((2, 256, 256), 8), ((1, 512, 512), 8)])
def test_clahe_twin_matches_jax_xla(shape, grid):
  rng = np.random.default_rng(shape[-1])
  img = rng.uniform(0, 1, shape).astype(np.float32)
  want = np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), grid_size=grid, backend='xla'))
  got = t_clahe.equalize_adapthist(_t(img), grid_size=grid).numpy()
  assert np.abs(got - want).max() <= 1e-5


def test_clahe_twin_matches_pallas_natural_route():
  rng = np.random.default_rng(45)
  img = rng.uniform(0, 1, (2, 256, 256)).astype(np.float32)
  b, h, w = img.shape
  g, nbins = 8, 256
  th, tw = h // g, w // g
  bins = jnp.clip((jnp.asarray(img) * nbins).astype(jnp.int32), 0,
                  nbins - 1).astype(jnp.uint8)
  pad_h, pad_w = th // 2, tw // 2
  bins_padded = jnp.pad(
      bins, ((0, 0), (pad_h, th - pad_h), (pad_w, tw - pad_w)), mode='edge')
  tiles = (bins.reshape(b, g, th, g, tw).transpose(0, 1, 3, 2, 4)
           .reshape(b, g * g, th * tw))
  out = j_cfp.clahe_fused_large_natural(
      bins_padded, tiles, g=g, th=th, tw=tw, nbins=nbins, clip_limit=0.01,
      interpret=True)
  want = np.asarray(out[:, pad_h:pad_h + h, pad_w:pad_w + w])
  got = t_clahe.equalize_adapthist(_t(img)).numpy()
  # The TPU route quantizes its blended LUTs to bf16; the port stays f32.
  assert np.abs(got - want).max() < 4e-3


def test_remap_twin_matches_jax_on_a_6_grid_with_128_bins():
  """Tiles of 40 x 60 pixels (no power of two, so the in-block weights are
  true divisions that a reciprocal would miss by a bit) and 128 bins,
  through the split pair's wrappers. Tolerance 1e-5: f32 on both sides,
  the cdf sums in another order."""
  rng = np.random.default_rng(46)
  img = (rng.uniform(size=(2, 240, 360)) ** 2.5).astype(np.float32)
  want = np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), grid_size=6, nbins=128, backend='xla'))
  _, mapping = t_cf.clahe_hist_lut(_t(img), grid_size=6, nbins=128)
  assert mapping.shape == (2, 6, 6, 128)
  got = t_cf.clahe_remap(_t(img), mapping).numpy()
  assert np.abs(got - want).max() <= 1e-5
  # The weights themselves: (row in block + 0.5) / th, divided, not
  # multiplied by a rounded 1 / th.
  ones = torch.ones((1, 6, 6, 128))
  ramp = t_cf.remap_reference(torch.zeros((1, 240, 360)), ones).numpy()
  np.testing.assert_allclose(ramp, 1.0, rtol=0, atol=2e-7)


def test_clahe_histograms_and_mapping_laws():
  rng = np.random.default_rng(9)
  img = rng.uniform(0, 1, (2, 64, 96)).astype(np.float32)
  hist, mapping = t_cf.clahe_hist_lut(_t(img), grid_size=4)
  assert hist.shape == mapping.shape == (2, 4, 4, 256)
  bins = np.clip((img * 256).astype(np.int32), 0, 255)
  tile = bins[1, 16:32, 48:72]
  np.testing.assert_array_equal(hist[1, 1, 2].numpy(),
                                np.bincount(tile.ravel(), minlength=256))
  m = mapping.numpy()
  assert np.all(np.diff(m, axis=-1) >= 0)
  np.testing.assert_allclose(m[..., -1], 1.0, rtol=1e-6)


def test_clahe_odd_tile_size_runs():
  # Tiles of 12 x 20 px: the port takes any tile size dividing the frame.
  img = torch.rand((1, 96, 160), generator=torch.Generator().manual_seed(0))
  out = t_clahe.equalize_adapthist(img, grid_size=8)
  assert out.shape == img.shape
  assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0 + 1e-6
  with pytest.raises(ValueError, match='divisible'):
    t_clahe.equalize_adapthist(torch.rand((1, 100, 100)), grid_size=8)


def _window_case(image_size, seed=0):
  """A JAX simulator reset with its window, and the same window in torch."""
  lat = j_lattice.make_lattice(50)
  state, obs = j_sim.reset(
      jax.random.PRNGKey(seed), lat, batch_size=3, return_window=True,
      config=j_sim.SimulatorConfig(image_size=image_size))
  w = obs.window
  t_window = t_struct.AtomWindow(
      positions=_t(w.positions), atomic_numbers=_t(w.atomic_numbers),
      mask=_t(w.mask), si_slot=_t(w.si_slot).long())
  t_fov = t_struct.FieldOfView(_t(state.fov.lower_left),
                               _t(state.fov.upper_right))
  return state, obs, t_window, t_fov


def test_render_clean_matches_jax():
  state, obs, t_window, t_fov = _window_case(128)
  want = np.asarray(j_render.render_clean_image(
      obs.window, state.fov, state.imaging.intensity_exponent,
      image_size=128, blur_amount=state.imaging.blur_amount))
  got = t_render.render_clean_image(
      t_window, t_fov, _t(state.imaging.intensity_exponent), image_size=128,
      blur_amount=_t(state.imaging.blur_amount)).numpy()
  assert np.abs(got - want).max() <= 1e-5


def test_atom_window_matches_jax():
  state, obs, _, t_fov = _window_case(128, seed=4)
  lat = t_lattice.make_lattice(50)
  material = t_struct.MaterialState(
      _t(state.material.offset), _t(state.material.theta),
      _t(state.material.si_index).long())
  got = t_sim.atom_window(lat, material, t_fov, 512)
  w = obs.window
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(w.mask))
  np.testing.assert_array_equal(got.atomic_numbers.numpy(),
                                np.asarray(w.atomic_numbers))
  np.testing.assert_array_equal(got.si_slot.numpy(), np.asarray(w.si_slot))
  np.testing.assert_allclose(got.positions.numpy(), np.asarray(w.positions),
                             atol=2e-6)


@pytest.mark.parametrize('size_in,size_out', [(512, 128), (384, 128),
                                              (128, 128)])
def test_resize_bilinear_strided_path_is_exact(size_in, size_out):
  rng = np.random.default_rng(size_in)
  img = rng.uniform(0, 1, (2, size_in, size_in)).astype(np.float32)
  want = np.asarray(j_render.resize_bilinear(jnp.asarray(img), size_out))
  got = t_render.resize_bilinear(_t(img), size_out).numpy()
  np.testing.assert_array_equal(got, want)


def test_resize_bilinear_general_path():
  rng = np.random.default_rng(1)
  img = rng.uniform(0, 1, (2, 100, 100)).astype(np.float32)
  want = np.asarray(j_render.resize_bilinear(jnp.asarray(img), 64))
  got = t_render.resize_bilinear(_t(img), 64).numpy()
  assert np.abs(got - want).max() < 1e-6


def test_imaging_params_laws_match_jax():
  n = 4000
  want = j_params.sample_imaging_params(jax.random.PRNGKey(0), n)
  got = t_params.sample_imaging_params(torch.Generator().manual_seed(0), n,
                                       device='cpu')
  for name in ('intensity_exponent', 'jitter_rate', 'poisson_rate_multiplier',
               'contrast_gamma', 'uniform_noise_scale'):
    p = scipy.stats.ks_2samp(np.asarray(getattr(want, name)),
                             getattr(got, name).numpy()).pvalue
    assert p > 1e-3, name


def test_render_stem_image_pipeline_on_cpu():
  _, obs, t_window, t_fov = _window_case(128, seed=2)
  params = t_params.sample_imaging_params(torch.Generator().manual_seed(1), 3,
                                          device='cpu')
  img = t_render.render_stem_image(torch.Generator().manual_seed(2),
                                   t_window, t_fov, params, image_size=128)
  assert img.shape == (3, 128, 128)
  assert bool(torch.isfinite(img).all())
  assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0 + 1e-6
