"""Port parity: geometry, lattice, rates and KMC against the JAX package.

Deterministic functions agree element-wise on the same numpy inputs;
the KMC agrees in distribution (the two packages draw from different
generators), held to the JAX package's own law at a fixed seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from putting_dune_torch import geometry as t_geometry
from putting_dune_torch import kmc as t_kmc
from putting_dune_torch import lattice as t_lattice
from putting_dune_torch import rates as t_rates
from putting_dune_tpu import geometry as j_geometry
from putting_dune_tpu import kmc as j_kmc
from putting_dune_tpu import lattice as j_lattice
from putting_dune_tpu import rates as j_rates

torch.set_num_threads(2)

J_LAT = j_lattice.make_lattice(20)
T_LAT = t_lattice.make_lattice(20)


def _t(x):
  return torch.from_numpy(np.array(x))


def test_geometry_matches_jax():
  rng = np.random.default_rng(0)
  pts = rng.normal(size=(64, 2)).astype(np.float32) * 5
  theta = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
  ll = rng.normal(size=(64, 2)).astype(np.float32)
  ur = ll + rng.uniform(15, 30, (64, 1)).astype(np.float32)
  np.testing.assert_allclose(
      t_geometry.get_angles(_t(pts)).numpy(),
      np.asarray(j_geometry.get_angles(jnp.asarray(pts))), atol=1e-6)
  np.testing.assert_allclose(
      t_geometry.rotate_coordinates(_t(pts), _t(theta)).numpy(),
      np.asarray(j_geometry.rotate_coordinates(pts, theta)), atol=1e-5)
  micro = rng.uniform(0, 1, (64, 2)).astype(np.float32)
  np.testing.assert_allclose(
      t_geometry.microscope_to_material(_t(micro), _t(ll), _t(ur)).numpy(),
      np.asarray(j_geometry.microscope_to_material(micro, ll, ur)),
      atol=1e-5)
  np.testing.assert_allclose(
      t_geometry.material_to_microscope(_t(pts), _t(ll), _t(ur)).numpy(),
      np.asarray(j_geometry.material_to_microscope(pts, ll, ur)), atol=1e-6)


@pytest.mark.parametrize('num_cols', [10, 50])
def test_lattice_matches_jax(num_cols):
  j = j_lattice.make_lattice(num_cols)
  t = t_lattice.make_lattice(num_cols)
  np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
  np.testing.assert_array_equal(t.neighbors.numpy(), np.asarray(j.neighbors))


def test_lattice_transforms_match_jax():
  rng = np.random.default_rng(1)
  offset = rng.uniform(-0.71, 0.71, (16, 2)).astype(np.float32)
  theta = rng.uniform(0, 2 * np.pi, 16).astype(np.float32)
  np.testing.assert_allclose(
      t_lattice.world_positions(T_LAT, _t(offset), _t(theta)).numpy(),
      np.asarray(j_lattice.world_positions(J_LAT, offset, theta)),
      atol=2e-5)
  si_t = t_lattice.initial_silicon_index(T_LAT, _t(offset))
  si_j = np.asarray(j_lattice.initial_silicon_index(J_LAT, offset))
  np.testing.assert_array_equal(si_t.numpy(), si_j)
  nbr = np.asarray(J_LAT.neighbors)[si_j]
  np.testing.assert_allclose(
      t_lattice.site_position(T_LAT, _t(nbr), _t(offset), _t(theta)).numpy(),
      np.asarray(j_lattice.site_position(J_LAT, jnp.asarray(nbr), offset,
                                         theta)),
      atol=2e-5)


def _rate_inputs(seed, n=512):
  rng = np.random.default_rng(seed)
  si = rng.normal(size=(n, 2)).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, (n, 1)) + np.array([0, 2.094, 4.189])
  nbr = (si[:, None, :] + 1.42 * np.stack(
      [np.cos(angle), np.sin(angle)], -1)).astype(np.float32)
  beam = (si + rng.normal(size=(n, 2)) * 1.5).astype(np.float32)
  return si, nbr, beam


@pytest.mark.parametrize('name', [
    'simple_canonical_rates', 'prior_rates'])
def test_rates_match_jax(name):
  si, nbr, beam = _rate_inputs(2)
  want = np.asarray(getattr(j_rates, name)(si, nbr, beam))
  got = getattr(t_rates, name)(_t(si), _t(nbr), _t(beam)).numpy()
  assert got.shape == want.shape == (512, 3)
  keep = want > 1e-30  # not underflowing to denormals
  rel = np.abs(got - want)[keep] / want[keep]
  # exp(e) carries the float32 rounding of its exponent e, which grows
  # with |e| (both packages sit ~2e-6 from a float64 oracle at |e| ~ 5),
  # so the bound is 1e-6 relative per unit of exponent, 1e-6 near the peak.
  max_rate = want.max()
  exponent = np.maximum(1.0, np.abs(np.log(want[keep] / max_rate)))
  assert np.max(rel / exponent) < 1e-6


# --- KMC ------------------------------------------------------------------------


def _kmc_case(n, dwell):
  """n identical lanes: silicon at the origin site, beam 0.4 A off it."""
  offset = np.zeros((n, 2), np.float32)
  theta = np.full((n,), 0.3, np.float32)
  si0 = np.asarray(j_lattice.initial_silicon_index(J_LAT, offset))
  si_pos = np.asarray(j_lattice.site_position(J_LAT, si0, offset, theta))
  beam = (si_pos + np.array([0.4, 0.3], np.float32)).astype(np.float32)
  return offset, theta, si0, beam, np.full((n,), dwell, np.float32)


def _run_both(n, dwell, record=0, max_events=None, seed=0):
  offset, theta, si0, beam, dwell_arr = _kmc_case(n, dwell)
  j = j_kmc.apply_control(
      jax.random.PRNGKey(seed), J_LAT, offset, theta, si0, beam, dwell_arr,
      j_rates.simple_canonical_rates, record_events=record,
      max_events=max_events)
  gen = torch.Generator().manual_seed(seed)
  t = t_kmc.apply_control(
      gen, T_LAT, _t(offset), _t(theta), _t(si0).long(), _t(beam),
      _t(dwell_arr), t_rates.simple_canonical_rates, record_events=record,
      max_events=max_events)
  return j, t, si0


def _rates_at_origin():
  offset, theta, si0, beam, _ = _kmc_case(1, 1.0)
  si = T_LAT.neighbors[_t(si0).long()]
  nbr_pos = t_lattice.site_position(T_LAT, si, _t(offset), _t(theta))
  si_pos = t_lattice.site_position(T_LAT, _t(si0).long(), _t(offset),
                                   _t(theta))
  return t_rates.simple_canonical_rates(si_pos, nbr_pos, _t(beam))[0].numpy()


def test_kmc_first_event_laws_match_jax_and_analytic():
  n, dwell = 20_000, 3.0
  j, t, si0 = _run_both(n, dwell, record=1)
  rates = _rates_at_origin().astype(np.float64)
  total = rates.sum()
  tj = np.asarray(j.event_times[0])
  tt = t.event_times[0].numpy()
  fired_j, fired_t = np.isfinite(tj), np.isfinite(tt)
  # P(first event within the dwell) = 1 - exp(-total * dwell).
  p = 1 - np.exp(-total * dwell)
  for fired in (fired_j, fired_t):
    assert abs(fired.mean() - p) < 4.5 * np.sqrt(p * (1 - p) / n)
  # Waiting times: KS port vs JAX, and port vs the truncated exponential.
  assert scipy.stats.ks_2samp(tj[fired_j], tt[fired_t]).pvalue > 1e-3
  cdf = lambda x: (1 - np.exp(-total * x)) / p  # noqa: E731
  assert scipy.stats.kstest(tt[fired_t], cdf).pvalue > 1e-3
  # Successor frequencies: r_i / total, in both packages.
  nbrs = T_LAT.neighbors[int(si0[0])].numpy()
  for sites in (np.asarray(j.event_sites[0])[fired_j],
                t.event_sites[0].numpy()[fired_t]):
    freq = np.array([(sites == s).mean() for s in nbrs])
    want = rates / total
    se = np.sqrt(want * (1 - want) / len(sites))
    assert np.all(np.abs(freq - want) < 4.5 * se), (freq, want)


def test_kmc_count_law_per_k_matches_jax():
  n = 20_000
  j, t, _ = _run_both(n, 6.0, seed=3)
  cj = np.asarray(j.num_transitions)
  ct = t.num_transitions.numpy()
  for k in range(6):
    pj, pt = (cj == k).mean(), (ct == k).mean()
    se = np.sqrt((pj * (1 - pj) + pt * (1 - pt)) / n) + 1e-12
    assert abs(pj - pt) < 4.5 * se, (k, pj, pt)
  assert scipy.stats.ks_2samp(cj, ct).pvalue > 1e-3


def test_kmc_max_events_cap_and_truncation():
  j, t, _ = _run_both(256, 1e6, max_events=5)
  assert int(t.num_transitions.max()) == 5
  assert bool(t.truncated.all())
  np.testing.assert_array_equal(np.asarray(j.truncated), t.truncated.numpy())


def test_kmc_zero_dwell_and_record_layout():
  offset, theta, si0, beam, _ = _kmc_case(8, 0.0)
  gen = torch.Generator().manual_seed(0)
  res = t_kmc.apply_control(
      gen, T_LAT, _t(offset), _t(theta), _t(si0).long(), _t(beam),
      torch.zeros(8), t_rates.simple_canonical_rates, record_events=3)
  assert res.event_times.shape == (3, 8)
  assert bool(torch.isinf(res.event_times).all())
  assert bool((res.event_sites == -1).all())
  np.testing.assert_array_equal(res.si_index.numpy(), si0)
