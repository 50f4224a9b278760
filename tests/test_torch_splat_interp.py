"""The fused splat and the CLAHE interpolation route against the JAX
package, on the CPU (the port's wrappers run their plain twins there; the
Pallas kernels run in interpret mode). Inputs are made with numpy from a
seed; tolerances are stated at each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from putting_dune_torch import structures as t_structures
from putting_dune_torch.imaging import clahe as t_clahe
from putting_dune_torch.imaging import render as t_render
from putting_dune_torch.ops import _build
from putting_dune_torch.ops import clahe_interp as t_interp
from putting_dune_torch.ops import splat as t_splat
from putting_dune_tpu import structures as j_structures
from putting_dune_tpu.imaging import clahe as j_clahe
from putting_dune_tpu.imaging import render as j_render
from putting_dune_tpu.ops import clahe_pallas as j_interp
from putting_dune_tpu.ops import splat_pallas as j_splat

torch.set_num_threads(2)


def _t(x):
  return torch.from_numpy(np.array(x))


def _splat_operands(seed, b, k, s):
  """Integer-valued bins of a jittered grid at graphene's bond length in
  pixels (S / 17.6 at a 25 A field of view), carbon weights with two
  silicons, a masked tail, sigmas near S / 54 with a little blur."""
  rng = np.random.default_rng(seed)
  pitch = s / 17.6
  n = int(np.ceil(np.sqrt(k)))
  gx, gy = np.meshgrid(np.arange(n), np.arange(n))
  base = np.stack([gx.ravel(), gy.ravel()], -1)[:k] * pitch
  pos = (base[None] + rng.uniform(0, s - n * pitch, (b, 1, 2))
         + rng.normal(0, 0.3, (b, k, 2)))
  bins = np.clip(np.floor(pos), 0, s - 1).astype(np.float32)
  w = np.full((b, k), 6.0 ** 1.7, np.float32)
  for i in range(b):
    w[i, rng.choice(k, 2, replace=False)] = 14.0 ** 1.7
  w[:, (2 * k) // 3:] = 0.0
  sx = (rng.uniform(0.9, 1.1, b) * s / 53.75).astype(np.float32)
  sy = (rng.uniform(0.9, 1.1, b) * s / 53.75).astype(np.float32)
  return bins[..., 0].copy(), bins[..., 1].copy(), w, sx, sy


def _window_case(seed, b, k):
  """An atom window with a silicon or two, a FOV and imaging scalars."""
  rng = np.random.default_rng(seed)
  positions = rng.uniform(0, 1, (b, k, 2)).astype(np.float32)
  positions[:, 0] = 1.0  # right and top edges fall into the last bin
  numbers = np.full((b, k), 6, np.int32)
  numbers[:, 1:3] = 14
  mask = np.ones((b, k), bool)
  mask[:, (3 * k) // 4:] = False
  lower = rng.uniform(-3, 3, (b, 2)).astype(np.float32)
  upper = lower + np.array([25.0, 20.0], np.float32)
  exponent = rng.uniform(1.4, 2.0, b).astype(np.float32)
  blur = rng.uniform(0.0, 1.0, b).astype(np.float32)
  return positions, numbers, mask, lower, upper, exponent, blur


# The Pallas kernel gathers in 128-lane segments: S is a multiple of 128.
@pytest.mark.parametrize('seed,b,k,s', [(0, 2, 96, 128), (2, 3, 40, 128)])
def test_splat_twin_matches_pallas_interpret(seed, b, k, s):
  ops = _splat_operands(seed, b, k, s)
  want = np.asarray(j_splat.splat_render(
      *[jnp.asarray(a) for a in ops], image_size=s, interpret=True))
  got = t_splat.splat_render(*[_t(a) for a in ops], image_size=s).numpy()
  assert got.shape == want.shape == (b, s, s)
  # The Pallas kernel contracts bf16 factors (its own test's bar against
  # the einsum route); the port keeps f32.
  assert np.abs(got - want).max() <= 5e-3
  assert got.max() == 1.0 and got.min() >= 0.0


@pytest.mark.parametrize('seed,b,k,s', [(0, 2, 96, 128), (1, 1, 40, 256)])
def test_splat_twin_rows_with_bf16_factors_match_pallas_interpret(
    seed, b, k, s):
  """The twin's profiles and shifted rows, cast to bf16 as the Pallas
  kernel casts them, give the Pallas frame to f32 rounding: what is left
  of the 5e-3 above is that cast alone."""
  ops = _splat_operands(seed, b, k, s)
  want = np.asarray(j_splat.splat_render(
      *[jnp.asarray(a) for a in ops], image_size=s, interpret=True))
  bx, by, w, sx, sy = [_t(a) for a in ops]
  gx = t_splat._shifted_rows(t_splat._profile(sx, s), bx.long(), s)
  gy = t_splat._shifted_rows(
      t_splat._profile(sy, s), (s - 1) - by.long(), s) * w[..., None]
  image = torch.bmm(gy.bfloat16().float().transpose(1, 2),
                    gx.bfloat16().float())
  got = (image / image.amax(dim=(-2, -1), keepdim=True)).numpy()
  # Both sum f32 products of the same bf16 factors, in another order.
  assert np.abs(got - want).max() <= 2e-5


@pytest.mark.parametrize('size', [64, 128])
@pytest.mark.parametrize('with_blur', [False, True])
def test_fused_backend_matches_jax_xla_and_the_default_route(size, with_blur):
  positions, numbers, mask, lower, upper, exponent, blur = _window_case(
      1, 3, 80)
  t_window = t_structures.AtomWindow(
      _t(positions), _t(numbers), _t(mask),
      torch.full((3,), -1, dtype=torch.int64))
  t_fov = t_structures.FieldOfView(_t(lower), _t(upper))
  j_window = j_structures.AtomWindow(
      jnp.asarray(positions), jnp.asarray(numbers), jnp.asarray(mask),
      jnp.full((3,), -1, jnp.int32))
  j_fov = j_structures.FieldOfView(jnp.asarray(lower), jnp.asarray(upper))
  want = np.asarray(j_render.render_clean_image(
      j_window, j_fov, jnp.asarray(exponent), image_size=size,
      blur_amount=jnp.asarray(blur) if with_blur else None, backend='xla'))
  kwargs = dict(image_size=size, blur_amount=_t(blur) if with_blur else None)
  got = t_render.render_clean_image(
      t_window, t_fov, _t(exponent), backend='fused', **kwargs).numpy()
  default = t_render.render_clean_image(
      t_window, t_fov, _t(exponent), **kwargs).numpy()
  # f32 exp, products and sums in two frameworks and two orders: 1e-5 on
  # frames normalized to 1.
  assert np.abs(got - want).max() <= 1e-5
  assert np.abs(got - default).max() <= 1e-5
  assert np.abs(default - want).max() <= 1e-5


def test_splat_twin_is_built_from_shifted_profile_rows():
  """One atom of weight 2 at bin (5, 9) of a 16^2 frame: the frame is the
  outer product of the two truncated profiles, shifted, y flipped."""
  s = 16
  sigma = np.array([1.0], np.float32)
  got = t_splat.splat_render(
      _t(np.array([[5.0]], np.float32)), _t(np.array([[9.0]], np.float32)),
      _t(np.array([[2.0]], np.float32)), _t(sigma), _t(sigma * 1.5),
      image_size=s).numpy()[0]
  cols = np.arange(s)
  px = np.where(np.abs(cols - 5) <= 4, np.exp(-0.5 * (cols - 5.0) ** 2), 0.0)
  row = s - 1 - 9
  py = np.where(np.abs(cols - row) <= 6,
                np.exp(-0.5 * ((cols - row) / 1.5) ** 2), 0.0)
  np.testing.assert_allclose(got, np.outer(py, px), atol=1e-6)
  assert got[row, 5] == 1.0 and got[row, 10] == 0.0  # truncated at radius 4


def test_splat_wrapper_checks_its_inputs():
  bx, by, w, sx, sy = [_t(a) for a in _splat_operands(2, 2, 8, 32)]
  with pytest.raises(TypeError, match='by'):
    t_splat.splat_render(bx, by.to(torch.float64), w, sx, sy, image_size=32)
  with pytest.raises(ValueError, match='contiguous'):
    t_splat.splat_render(bx, by, w.t().contiguous().t(), sx, sy,
                         image_size=32)
  with pytest.raises(ValueError, match='share a shape'):
    t_splat.splat_render(bx, by[:, :4].contiguous(), w, sx, sy, image_size=32)
  with pytest.raises(ValueError, match=r'\(B,\)'):
    t_splat.splat_render(bx, by, w, sx[:1], sy, image_size=32)
  with pytest.raises(ValueError, match='image_size'):
    t_splat.splat_render(bx, by, w, sx, sy, image_size=4096)
  before = dict(_build.LAUNCHES)
  t_splat.splat_render(bx, by, w, sx, sy, image_size=32)
  assert _build.LAUNCHES == before  # a CPU call launches no kernel


@pytest.mark.parametrize('b,k,p,v', [(2, 9, 64, 256), (3, 25, 48, 64)])
def test_interp_twin_matches_pallas_interpret(b, k, p, v):
  rng = np.random.default_rng(3)
  blocks = rng.integers(0, v, (b, k, p)).astype(np.int32)
  luts = rng.uniform(0, 1, (b, k, v, 4)).astype(np.float32)
  wgt = rng.dirichlet(np.ones(4), p).astype(np.float32)
  want = np.asarray(j_interp.clahe_interpolate(
      jnp.asarray(blocks), jnp.asarray(luts), jnp.asarray(wgt),
      interpret=True))
  got = t_interp.clahe_interpolate(_t(blocks), _t(luts), _t(wgt)).numpy()
  assert got.shape == want.shape == (b, k, p)
  # The Pallas kernel reads its LUTs in bf16 (8 mantissa bits on values in
  # [0, 1]); the port keeps f32.
  assert np.abs(got - want).max() <= 4e-3
  # And exactly the definition, in float64.
  ref = np.einsum('bkpc,pc->bkp', np.take_along_axis(
      luts.astype(np.float64), blocks[..., None, None].astype(np.int64)
      .repeat(4, -1), axis=2)[:, :, :, 0, :] if False else
      luts.astype(np.float64)[np.arange(b)[:, None, None],
                              np.arange(k)[None, :, None], blocks],
      wgt.astype(np.float64))
  np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize('shape,grid,nbins', [
    ((2, 64, 64), 8, 256), ((2, 64, 64), 2, 256), ((1, 96, 160), 4, 128)])
def test_interp_route_matches_jax_xla_and_the_default_route(shape, grid, nbins):
  rng = np.random.default_rng(shape[-1] + grid)
  img = (rng.uniform(0, 1, shape) ** 2).astype(np.float32)
  want = np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), grid_size=grid, nbins=nbins, backend='xla'))
  got = t_clahe.equalize_adapthist(
      _t(img), grid_size=grid, nbins=nbins, backend='interp').numpy()
  default = t_clahe.equalize_adapthist(
      _t(img), grid_size=grid, nbins=nbins).numpy()
  # The tolerance tests/test_torch_imaging.py holds the default route to.
  assert np.abs(got - want).max() <= 1e-5
  # Both port routes blend the same f32 mappings with the same weights.
  assert np.abs(got - default).max() <= 2e-6


def test_interp_route_matches_jax_pallas_backend():
  rng = np.random.default_rng(11)
  img = rng.uniform(0, 1, (2, 64, 64)).astype(np.float32)
  want = np.asarray(j_clahe.equalize_adapthist(
      jnp.asarray(img), backend='pallas'))
  got = t_clahe.equalize_adapthist(_t(img), backend='interp').numpy()
  assert np.abs(got - want).max() <= 4e-3  # bf16 LUTs there, f32 here


def test_dual_block_inputs_match_the_jax_layout():
  rng = np.random.default_rng(12)
  img = rng.uniform(0, 1, (2, 32, 48)).astype(np.float32)
  g, nbins = 4, 256
  th, tw = 32 // g, 48 // g
  blocks, luts, wgt = t_clahe.dual_block_inputs(_t(img), 0.01, g, nbins)
  assert blocks.dtype == torch.int32 and blocks.shape == (2, 25, th * tw)
  assert luts.shape == (2, 25, nbins, 4) and wgt.shape == (th * tw, 4)
  assert blocks.is_contiguous() and luts.is_contiguous()
  bins = jnp.clip((jnp.asarray(img) * nbins).astype(jnp.int32), 0, nbins - 1)
  padded = jnp.pad(bins, ((0, 0), (th // 2, th - th // 2),
                          (tw // 2, tw - tw // 2)), mode='edge')
  want = (padded.reshape(2, g + 1, th, g + 1, tw).transpose(0, 1, 3, 2, 4)
          .reshape(2, 25, th * tw))
  np.testing.assert_array_equal(blocks.numpy(), np.asarray(want))
  np.testing.assert_allclose(wgt.sum(-1).numpy(), 1.0, atol=1e-6)
  # Corner (0, 0) of the first dual block and corner (g-1, g-1) of the last
  # are the same tile's mapping on all four corners (edge clamping).
  for block in (0, 24):
    for c in range(1, 4):
      assert torch.equal(luts[:, block, :, 0], luts[:, block, :, c])


def test_padded_clahe_takes_the_backend():
  img = torch.rand((2, 100, 70), generator=torch.Generator().manual_seed(0))
  want = t_clahe.equalize_adapthist_padded(img)
  got = t_clahe.equalize_adapthist_padded(img, backend='interp')
  assert got.shape == (2, 100, 70)
  assert float((got - want).abs().max()) <= 2e-6
  aligned = torch.rand((1, 64, 64), generator=torch.Generator().manual_seed(1))
  assert float((t_clahe.equalize_adapthist_padded(aligned, backend='interp')
                - t_clahe.equalize_adapthist(aligned)).abs().max()) <= 2e-6


@pytest.mark.parametrize('fn,name', [
    (lambda **kw: t_clahe.equalize_adapthist(torch.rand((1, 64, 64)), **kw),
     'equalize_adapthist'),
    (lambda **kw: t_clahe.equalize_adapthist_padded(
        torch.rand((1, 60, 64)), **kw), 'equalize_adapthist_padded'),
])
@pytest.mark.parametrize('backend', ['pallas', 'xla', 'fused', ''])
def test_clahe_backends_reject_unknown_values(fn, name, backend):
  with pytest.raises(ValueError, match='backend'):
    fn(backend=backend)


@pytest.mark.parametrize('with_blur', [False, True])
def test_auto_on_cpu_tensors_is_the_bmm_route_bit_for_bit(with_blur):
  positions, numbers, mask, lower, upper, exponent, blur = _window_case(
      5, 3, 80)
  window = t_structures.AtomWindow(
      _t(positions), _t(numbers), _t(mask),
      torch.full((3,), -1, dtype=torch.int64))
  fov = t_structures.FieldOfView(_t(lower), _t(upper))
  kwargs = dict(image_size=96, blur_amount=_t(blur) if with_blur else None)
  auto = t_render.render_clean_image(window, fov, _t(exponent), **kwargs)
  bmm = t_render.render_clean_image(window, fov, _t(exponent),
                                    backend='bmm', **kwargs)
  assert torch.equal(auto, bmm)
  assert float(bmm.amax()) == 1.0


@pytest.mark.parametrize('backend,wrapper', [
    ('auto', 1), ('fused', 1), ('bmm', 0)])
def test_every_splat_backend_runs_the_plain_splat_on_cpu_tensors(
    monkeypatch, backend, wrapper):
  """On CPU tensors each backend reaches `splat_render_reference` once,
  'auto' and 'fused' through the kernel's wrapper (its CPU branch), 'bmm'
  directly; no kernel is launched."""
  positions, numbers, mask, lower, upper, exponent, _ = _window_case(4, 2, 8)
  window = t_structures.AtomWindow(
      _t(positions), _t(numbers), _t(mask),
      torch.full((2,), -1, dtype=torch.int64))
  fov = t_structures.FieldOfView(_t(lower), _t(upper))
  calls = {'splat_render': 0, 'splat_render_reference': 0}
  for name in calls:
    def counted(*args, _fn=getattr(t_splat, name), _name=name, **kwargs):
      calls[_name] += 1
      return _fn(*args, **kwargs)
    monkeypatch.setattr(t_splat, name, counted)
  before = dict(_build.LAUNCHES)
  image = t_render.render_clean_image(window, fov, _t(exponent),
                                      image_size=32, backend=backend)
  assert calls == {'splat_render': wrapper, 'splat_render_reference': 1}
  assert _build.LAUNCHES == before
  assert float(image.amax()) == 1.0


@pytest.mark.parametrize('backend', ['pallas', 'xla', 'interp', ''])
def test_splat_backend_rejects_unknown_values(backend):
  positions, numbers, mask, lower, upper, exponent, _ = _window_case(4, 1, 8)
  window = t_structures.AtomWindow(
      _t(positions), _t(numbers), _t(mask),
      torch.full((1,), -1, dtype=torch.int64))
  fov = t_structures.FieldOfView(_t(lower), _t(upper))
  with pytest.raises(ValueError, match='backend'):
    t_render.render_clean_image(window, fov, _t(exponent), image_size=32,
                                backend=backend)


def test_interp_wrapper_checks_its_inputs():
  blocks = torch.zeros((2, 9, 16), dtype=torch.int32)
  luts = torch.zeros((2, 9, 64, 4))
  wgt = torch.zeros((16, 4))
  with pytest.raises(TypeError, match='blocks'):
    t_interp.clahe_interpolate(blocks.to(torch.int64), luts, wgt)
  with pytest.raises(TypeError, match='luts'):
    t_interp.clahe_interpolate(blocks, luts.to(torch.float64), wgt)
  with pytest.raises(ValueError, match='luts'):
    t_interp.clahe_interpolate(blocks, luts[:, :8].contiguous(), wgt)
  with pytest.raises(ValueError, match='weights'):
    t_interp.clahe_interpolate(blocks, luts, wgt[:8].contiguous())
  with pytest.raises(ValueError, match='contiguous'):
    t_interp.clahe_interpolate(blocks, luts.transpose(1, 2), wgt)
  with pytest.raises(ValueError, match='nbins'):
    t_interp.clahe_interpolate(blocks, torch.zeros((2, 9, 2048, 4)), wgt)
  before = dict(_build.LAUNCHES)
  out = t_interp.clahe_interpolate(blocks, luts, wgt)
  assert out.shape == (2, 9, 16) and _build.LAUNCHES == before


def test_new_kernels_are_registered_with_sources():
  assert _build.KERNELS[-2:] == ('splat_render', 'clahe_interp')
  for name in ('splat_render', 'clahe_interp'):
    source = (_build.SRC_DIR / f'{name}.cu').read_text()
    assert f'extern "C" int {name}_launch' in source
    assert 'cublas' not in source.lower() and 'torch' not in source.lower()
    assert _build.LAUNCHES[name] == 0
