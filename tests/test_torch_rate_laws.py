"""The port's rate laws and msgpack writer against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in putting_dune_torch in one process. Tolerances are
stated at each test: 1e-6 absolute unless said.
"""

import msgpack
import numpy as np
import pytest
import torch
import flax.serialization

import jax.numpy as jnp

from putting_dune_torch import rates as t_rates
from putting_dune_torch.agents import msgpack_reader
from putting_dune_torch.io import serialization as t_serialization
from putting_dune_tpu import rates as j_rates
from putting_dune_tpu.io import serialization as j_serialization

torch.set_num_threads(2)

BOND = 1.42


def _t(x):
  return torch.from_numpy(np.array(x))


def _rate_inputs(seed, n=512):
  """Silicon anywhere, its three neighbors at a random lattice rotation,
  the beam within ~2 bonds."""
  rng = np.random.default_rng(seed)
  si = (rng.normal(size=(n, 2)) * 3).astype(np.float32)
  angle = rng.uniform(0, 2 * np.pi, (n, 1)) + np.array([0, 2.094, 4.189])
  nbr = (si[:, None, :] + BOND * np.stack(
      [np.cos(angle), np.sin(angle)], -1)).astype(np.float32)
  beam = (si + rng.normal(size=(n, 2)) * 1.5).astype(np.float32)
  return si, nbr, beam


OVERRIDES = {
    'defaults': {},
    'mean': {'mean': np.array([0.6, 0.2], np.float32)},
    'cov': {'cov': np.array([[0.2, 0.05], [0.05, 0.15]], np.float32)},
    'max_rate': {'max_rate': 0.5},
    'all': {'mean': np.array([1.1, -0.3], np.float32),
            'cov': np.array([[0.3, 0.0], [0.0, 0.08]], np.float32),
            'max_rate': 0.9},
}


@pytest.mark.parametrize('name', ['prior_rates', 'prior_rates_aligned'])
@pytest.mark.parametrize('override', sorted(OVERRIDES))
def test_prior_rates_with_overrides_match_jax(name, override):
  si, nbr, beam = _rate_inputs(1)
  kwargs = OVERRIDES[override]
  want = np.asarray(getattr(j_rates, name)(si, nbr, beam, **kwargs))
  got = getattr(t_rates, name)(_t(si), _t(nbr), _t(beam), **kwargs).numpy()
  assert got.shape == want.shape == (512, 3)
  # Rates are <= max_rate <= 0.9: 1e-6 absolute.
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  assert want.max() > 0.1 * kwargs.get('max_rate', np.log(2) / 3)


def test_aligned_prior_peaks_toward_each_neighbor_and_reference_reflects():
  # Beam 0.85 bonds toward neighbor k: the aligned law peaks at k; the
  # reference law at the reflection of k (which is k only on the x-axis).
  angles = np.deg2rad([30.0, 150.0, 270.0])
  nbr = BOND * np.stack([np.cos(angles), np.sin(angles)], -1)
  for k in range(3):
    beam = 0.85 * nbr[k]
    args = (_t(np.zeros((1, 2), np.float32)),
            _t(nbr[None].astype(np.float32)),
            _t(beam[None].astype(np.float32)))
    aligned = t_rates.prior_rates_aligned(*args).numpy()[0]
    assert int(np.argmax(aligned)) == k
    np.testing.assert_allclose(aligned[k], np.log(2) / 3, rtol=1e-5)
    reflected = t_rates.prior_rates(*args).numpy()[0]
    assert reflected[k] < 0.5 * aligned[k]


def _gmm_pair(seed):
  j_gmm = j_rates.GaussianMixtureRateFunction.sample_new(
      np.random.default_rng(seed))
  t_gmm = t_rates.GaussianMixtureRateFunction.sample_new(
      np.random.default_rng(seed))
  return j_gmm, t_gmm


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4])
def test_gmm_sample_new_draws_what_jax_draws(seed):
  j_gmm, t_gmm = _gmm_pair(seed)
  assert t_gmm.max_rate == j_gmm.max_rate
  for field in ('mixture_weights', 'loc_distances', 'variances'):
    np.testing.assert_array_equal(getattr(t_gmm, field),
                                  getattr(j_gmm, field))
  assert t_gmm.normalizing_factor == j_gmm.normalizing_factor


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4])
def test_gmm_call_matches_jax(seed):
  j_gmm, t_gmm = _gmm_pair(seed)
  si, nbr, beam = _rate_inputs(10 + seed)
  want = np.asarray(j_gmm(jnp.asarray(si), jnp.asarray(nbr),
                          jnp.asarray(beam)))
  got = t_gmm(_t(si), _t(nbr), _t(beam)).numpy()
  assert got.shape == want.shape == (512, 3)
  # The largest component peak is max_rate <= 1; a sum of M components
  # stays below M: 1e-6 absolute, 1e-5 relative where the rates exceed 0.1.
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  assert want.max() > 1e-3


def test_gmm_equality_and_hash_as_in_jax():
  # Equal within 1e-3 per field, unequal beyond it or in another shape;
  # the same verdicts as the JAX class on the same pairs.
  pairs = []
  for cls in (j_rates.GaussianMixtureRateFunction,
              t_rates.GaussianMixtureRateFunction):
    a = cls.sample_new(np.random.default_rng(7))
    near = cls(max_rate=a.max_rate, mixture_weights=a.mixture_weights + 5e-4,
               loc_distances=a.loc_distances - 5e-4, variances=a.variances)
    far = cls(max_rate=a.max_rate + 2e-3, mixture_weights=a.mixture_weights,
              loc_distances=a.loc_distances, variances=a.variances)
    other = cls.sample_new(np.random.default_rng(8))
    pairs.append([a == near, hash(a) == hash(near), a == far, a == other,
                  hash(a)])
  assert pairs[0] == pairs[1]
  assert pairs[1][:3] == [True, True, False]


@pytest.mark.parametrize('seed', [0, 3])
def test_gmm_bundle_crosses_both_ways(seed, tmp_path):
  j_gmm, t_gmm = _gmm_pair(seed)
  t_gmm.serialize_to_directory(tmp_path / 'port')
  j_gmm.serialize_to_directory(tmp_path / 'jax')
  # The two bundles are the same bytes.
  port_bytes = (tmp_path / 'port' / 'gmm_parameters.mpk').read_bytes()
  assert port_bytes == (tmp_path / 'jax' / 'gmm_parameters.mpk').read_bytes()
  from_port = j_rates.GaussianMixtureRateFunction.deserialize_from_directory(
      tmp_path / 'port')
  from_jax = t_rates.GaussianMixtureRateFunction.deserialize_from_directory(
      tmp_path / 'jax')
  for restored in (from_port, from_jax):
    assert restored.max_rate == t_gmm.max_rate
    for field in ('mixture_weights', 'loc_distances', 'variances'):
      np.testing.assert_array_equal(getattr(restored, field),
                                    getattr(t_gmm, field))


# --- the msgpack writer ---------------------------------------------------------


MSGPACK_VALUES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**63, -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1,
    -2**63, 1.5, -0.0, 'x' * 31, 'y' * 32, 'z' * 300, 'w' * 70000, b'',
    b'a' * 300, b'b' * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, {'k': b'v'}] for i in range(16)}, 'ünïcode',
]


@pytest.mark.parametrize('index', range(len(MSGPACK_VALUES)))
def test_packb_writes_what_msgpack_writes(index):
  value = MSGPACK_VALUES[index]
  data = t_serialization.packb(value)
  assert data == msgpack.packb(value)
  assert msgpack_reader.unpackb(data) == value


def test_flax_to_bytes_equals_flax_and_reads_back():
  rng = np.random.default_rng(0)
  tree = {
      'Dense_0': {'kernel': rng.normal(size=(3, 4, 128)).astype(np.float32),
                  'bias': np.zeros((3, 128), np.float32)},
      'BatchNorm_0': {'scale': np.ones((3, 4), np.float32),
                      'bias': rng.normal(size=(3, 4)).astype(np.float32)},
      'big': rng.normal(size=(3, 128, 128)).astype(np.float32),
      'step': np.int64(7), 'flag': np.zeros((2,), np.int32),
  }
  data = t_serialization.to_bytes(tree)
  assert data == flax.serialization.to_bytes(tree)
  restored = flax.serialization.msgpack_restore(data)
  out = t_serialization.unpackb(data)
  for got in (restored, out):
    np.testing.assert_array_equal(got['big'], tree['big'])
    np.testing.assert_array_equal(got['Dense_0']['kernel'],
                                  tree['Dense_0']['kernel'])
    assert got['step'] == 7


def test_msgpack_numpy_layout_matches_the_jax_codec():
  rng = np.random.default_rng(1)
  bundle = {'a': rng.normal(size=(3, 2)), 'b': np.arange(5, dtype=np.int32),
            'c': np.float32(2.5), 'd': 'text'}
  data = t_serialization.packb(bundle, default=t_serialization.msgpack_encode)
  assert data == msgpack.packb(bundle, default=j_serialization.msgpack_encode)
  decoded = t_serialization.msgpack_decode_tree(
      t_serialization.unpackb(data))
  np.testing.assert_array_equal(decoded['a'], bundle['a'])
  np.testing.assert_array_equal(decoded['b'], bundle['b'])
  assert decoded['c'] == 2.5 and decoded['d'] == 'text'
  legacy = {'__ndarray__': True, 'data': bundle['b'].tobytes(),
            'dtype': '<i4', 'shape': [5]}
  np.testing.assert_array_equal(t_serialization.msgpack_decode(legacy),
                                bundle['b'])
  with pytest.raises(TypeError):
    t_serialization.packb(object())
