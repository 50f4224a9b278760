"""Record files across the two packages: TFRecord and riegeli.

Files written by each package are read by the other with payloads equal
(riegeli with every codec this machine has: the writers' bytes are equal
too), the golden riegeli files (written by the real riegeli C++ writer,
simple and transposed) read identically in both, corruption raises in
both, and the port's C++ CRC32C and HighwayHash-64 equal their plain
Python twins (the CRC through the TFRecord framing), the JAX package's
and google_crc32c / the array_record wheel's HighwayHash64_Portable.
Exact equality everywhere: these are bytes.
"""

import ctypes
import datetime as dt
import os
import random

import numpy as np
import pytest

from putting_dune_torch import microscope_data as t_md
from putting_dune_torch.io import native
from putting_dune_torch.io import records as t_records
from putting_dune_torch.io import riegeli_native as t_rn
from putting_dune_tpu import microscope_data as j_md
from putting_dune_tpu.io import records as j_records
from putting_dune_tpu.io import riegeli_native as j_rn

DATA = os.path.join(os.path.dirname(__file__), 'data')
GOLDEN = os.path.join(DATA, 'golden.riegeli')
GOLDEN_TRANSPOSED = os.path.join(DATA, 'golden_transposed.riegeli')
CODECS = t_rn.available_codecs()


def _payloads(seed, n=60, most=3000):
  rng = np.random.default_rng(seed)
  return [rng.bytes(int(k)) for k in rng.integers(0, most, n)] + [b'']


# --- the hashes --------------------------------------------------------------


def test_crc32c_twin_equals_google_crc32c():
  # The native CRC32C is held to this twin by the TFRecord framing below.
  google_crc32c = pytest.importorskip('google_crc32c')
  rng = np.random.default_rng(0)
  for size in (0, 1, 7, 8, 9, 63, 64, 100, 4097):
    data = rng.bytes(size)
    assert native.crc32c_py(data) == google_crc32c.value(data)


def _oracle_hash64():
  mod = pytest.importorskip('array_record.python.array_record_module')
  fn = ctypes.CDLL(mod.__file__).HighwayHash64_Portable
  fn.restype = ctypes.c_uint64
  fn.argtypes = [ctypes.POINTER(ctypes.c_uint64 * 4), ctypes.c_char_p,
                 ctypes.c_uint64]
  return lambda key, data: int(fn(ctypes.byref((ctypes.c_uint64 * 4)(*key)),
                                  data, len(data)))


def test_highwayhash_native_equals_twin_jax_and_reference():
  oracle = _oracle_hash64()
  rng = np.random.default_rng(7)
  for size in (0, 1, 3, 4, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 1000):
    data = rng.bytes(size)
    for key in (t_rn.RIEGELI_HASH_KEY,
                tuple(int(x) for x in rng.integers(0, 2**63, 4))):
      want = oracle(key, data)
      assert t_rn.highwayhash64(data, key) == want, size
      assert t_rn.highwayhash64_py(data, key) == want, size
      assert j_rn.highwayhash64(data, key) == want, size


def test_native_library_is_hash_named_and_reused():
  path = native.build()
  assert path == native.library_path() and path.exists()
  assert path.parent.name == '_build' and path.name.startswith('records-')
  assert native.build() == path


# --- TFRecord ----------------------------------------------------------------


def test_tfrecord_written_by_each_package_read_by_the_other(tmp_path):
  payloads = _payloads(1)
  port_path, jax_path = str(tmp_path / 'p.tfrecords'), str(
      tmp_path / 'j.tfrecords')
  t_records.write_tfrecords(port_path, payloads)
  j_records.write_tfrecords(jax_path, payloads)
  with open(port_path, 'rb') as f:
    port_bytes = f.read()
  with open(jax_path, 'rb') as f:
    assert port_bytes == f.read()
  # The framing equals the plain twin's.
  assert port_bytes == b''.join(t_records.frame_py(p) for p in payloads)
  assert j_records.read_tfrecords(port_path) == payloads
  assert t_records.read_tfrecords(jax_path) == payloads
  assert t_records.count_tfrecords(jax_path) == len(payloads)


def test_tfrecord_empty_file(tmp_path):
  path = str(tmp_path / 'e.tfrecords')
  t_records.write_tfrecords(path, [])
  assert os.path.getsize(path) == 0
  assert t_records.read_tfrecords(path) == [] == j_records.read_tfrecords(path)


@pytest.mark.parametrize('offset', [3, 9, 20, -2])
def test_tfrecord_corruption_raises_in_both(tmp_path, offset):
  path = str(tmp_path / 'c.tfrecords')
  t_records.write_tfrecords(path, [b'abcdefghij', b'klmnop'])
  raw = bytearray(open(path, 'rb').read())
  raw[offset] ^= 0x40
  with open(path, 'wb') as f:
    f.write(bytes(raw))
  with pytest.raises(IOError):
    t_records.read_tfrecords(path)
  with pytest.raises(IOError):
    j_records.read_tfrecords(path)
  # Unverified reads skip the CRCs, as the JAX package's do.
  if offset >= 12:
    assert (t_records.read_tfrecords(path, verify_crc=False)
            == j_records.read_tfrecords(path, verify_crc=False))


# --- riegeli -----------------------------------------------------------------


@pytest.mark.parametrize('codec', CODECS)
def test_riegeli_written_by_each_package_read_by_the_other(tmp_path, codec):
  payloads = _payloads(2, n=80, most=5000)
  port_path, jax_path = str(tmp_path / 'p.riegeli'), str(
      tmp_path / 'j.riegeli')
  t_rn.write_riegeli_records(port_path, payloads, compression=codec,
                             chunk_target_bytes=50_000)
  j_rn.write_riegeli_records(jax_path, payloads, compression=codec,
                             chunk_target_bytes=50_000)
  assert os.path.getsize(port_path) > t_rn.BLOCK_SIZE
  with open(port_path, 'rb') as f, open(jax_path, 'rb') as g:
    assert f.read() == g.read()
  assert j_rn.read_riegeli_records(port_path) == payloads
  assert t_rn.read_riegeli_records(jax_path) == payloads


def test_riegeli_default_codec_is_brotli_when_present(tmp_path):
  path = str(tmp_path / 'd.riegeli')
  t_rn.write_riegeli_records(path, [b'x' * 100])
  data = open(path, 'rb').read()
  # The simple chunk's compression byte follows the 64-byte prefix and
  # the chunk's 40-byte header.
  want = t_rn.COMPRESSION_BROTLI if 'brotli' in CODECS else 0
  assert data[64 + 40] == want


@pytest.mark.parametrize('path', [GOLDEN, GOLDEN_TRANSPOSED],
                         ids=['simple', 'transposed'])
def test_golden_files_read_identically(path):
  got = t_rn.read_riegeli_records(path, verify=True)
  assert got == j_rn.read_riegeli_records(path, verify=True)
  assert t_rn.read_array_record(path) == j_rn.read_array_record(path)
  trajectories = []
  for payload in got:
    try:
      port = t_md.Trajectory.from_proto_bytes(payload)
    except Exception:  # array_record's own metadata records
      continue
    if len(port.observations) == 2:
      jax = j_md.Trajectory.from_proto_bytes(payload)
      assert port.to_proto_bytes() == jax.to_proto().SerializeToString(
          deterministic=True)
      trajectories.append(port)
  assert len(trajectories) == (1 if path == GOLDEN else 2)


def test_writer_prefix_matches_the_real_writer(tmp_path):
  path = str(tmp_path / 'sig.riegeli')
  t_rn.write_riegeli_records(path, [b'x'], compression='uncompressed')
  assert open(path, 'rb').read(64) == open(GOLDEN, 'rb').read(64)


def _writer(path, options):
  mod = pytest.importorskip('array_record.python.array_record_module')
  return mod.ArrayRecordWriter(path, options)


@pytest.mark.parametrize('codec', CODECS)
def test_real_transposed_chunks_read_as_the_jax_package_reads(tmp_path,
                                                               codec):
  rng = random.Random(7)

  def rand_proto(depth=0):
    out = bytearray()
    for _ in range(rng.randint(0, 5)):
      field, wt = rng.randint(1, 300), rng.choice([0, 1, 2, 5])
      out += t_rn._encode_varint((field << 3) | wt)
      if wt == 0:
        out += t_rn._encode_varint(rng.randint(0, 2**56))
      elif wt in (1, 5):
        out += rng.randbytes(8 if wt == 1 else 4)
      elif depth < 3 and rng.random() < 0.5:
        inner = rand_proto(depth + 1)
        out += t_rn._encode_varint(len(inner)) + inner
      else:
        s = rng.randbytes(rng.randint(0, 40))
        out += t_rn._encode_varint(len(s)) + s
    return bytes(out)

  payloads = [rand_proto() for _ in range(60)] + [b'not a proto', b'']
  for options in (f'transpose,{codec}', f'transpose,{codec},group_size:7',
                  codec):
    path = str(tmp_path / 't.riegeli')
    writer = _writer(path, options)
    for p in payloads:
      writer.write(p)
    writer.close()
    got = t_rn.read_riegeli_records(path)
    assert got == j_rn.read_riegeli_records(path)
    assert t_rn.read_array_record(path) == payloads


def _flip(path, offset):
  raw = bytearray(open(path, 'rb').read())
  raw[offset] ^= 0x01
  with open(path, 'wb') as f:
    f.write(bytes(raw))


@pytest.mark.parametrize('offset', [2, 70, 64 + 41, -3],
                         ids=['block header', 'chunk header', 'chunk data',
                              'tail'])
def test_riegeli_corruption_raises_in_both(tmp_path, offset):
  path = str(tmp_path / 'c.riegeli')
  t_rn.write_riegeli_records(path, _payloads(3, n=10, most=200),
                             compression='uncompressed')
  _flip(path, offset)
  with pytest.raises(t_rn.RiegeliFormatError, match='hash mismatch'):
    t_rn.read_riegeli_records(path)
  with pytest.raises(j_rn.RiegeliFormatError, match='hash mismatch'):
    j_rn.read_riegeli_records(path)


def test_riegeli_rejects_other_files_and_truncation(tmp_path):
  with pytest.raises(t_rn.RiegeliFormatError, match='hash mismatch'):
    t_rn.read_riegeli_records(__file__)
  with pytest.raises(t_rn.RiegeliFormatError, match='signature'):
    t_rn.read_riegeli_records(__file__, verify=False)
  path = str(tmp_path / 'trunc.riegeli')
  with open(path, 'wb') as f:
    f.write(open(GOLDEN, 'rb').read(100))
  with pytest.raises(t_rn.RiegeliFormatError):
    t_rn.read_riegeli_records(path)


def test_named_codec_without_its_library_raises(tmp_path, monkeypatch):
  monkeypatch.setitem(t_rn._COMPRESSORS, t_rn.COMPRESSION_ZSTD,
                      lambda data: None)
  with pytest.raises(RuntimeError, match='zstd'):
    t_rn.write_riegeli_records(str(tmp_path / 'z.riegeli'), [b'x'],
                               compression='zstd')
  with pytest.raises(ValueError, match='unknown riegeli compression'):
    t_rn.write_riegeli_records(str(tmp_path / 'z.riegeli'), [b'x'],
                               compression='lz4')


def test_missing_brotli_means_uncompressed_by_default(tmp_path, monkeypatch):
  monkeypatch.setattr(t_rn, '_brotli_compress', lambda data: None)
  path = str(tmp_path / 'n.riegeli')
  t_rn.write_riegeli_records(path, [b'y' * 50])
  assert open(path, 'rb').read()[64 + 40] == t_rn.COMPRESSION_NONE
  assert j_rn.read_riegeli_records(path) == [b'y' * 50]


# --- the extension dispatch --------------------------------------------------


@pytest.mark.parametrize('ext', ['.tfrecords', '.tfrecord', '.riegeli'])
def test_write_records_dispatch_both_ways(tmp_path, ext):
  rng = np.random.default_rng(5)
  grid = (rng.random((4, 2)), np.asarray([6, 14, 6, 6]))
  fov = ([0.0, 0.0], [12.5, 12.5])
  images = [rng.random((6, 6)).astype(np.float32) for _ in range(3)]

  def trajectory(md):
    return md.Trajectory(tuple(md.MicroscopeObservation(
        grid=md.AtomicGrid(*grid), fov=md.MicroscopeFieldOfView(*fov),
        controls=(md.BeamControl([0.25, 0.5], dt.timedelta(seconds=2.0)),),
        elapsed_time=dt.timedelta(seconds=float(i)), image=image)
        for i, image in enumerate(images)))

  port_path, jax_path = str(tmp_path / f'p{ext}'), str(tmp_path / f'j{ext}')
  t_records.write_records(port_path, [trajectory(t_md)])
  j_records.write_records(jax_path, [trajectory(j_md)])
  assert t_records.read_records(jax_path) == j_records.read_records(
      port_path)
  back = t_records.read_records(jax_path, t_md.Trajectory)[0]
  assert len(back.observations) == 3
  assert back.observations[0].grid == t_md.AtomicGrid(*grid)
  with pytest.raises(ValueError, match='extension'):
    t_records.write_records(str(tmp_path / 'x.mpk'), [b''])
