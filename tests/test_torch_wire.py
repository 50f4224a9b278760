"""The port's protobuf wire codec against protobuf itself.

Every message of the schema is filled from a numpy seed (200 per type:
negatives, NaN and infinities, empty strings and bytes, unset optionals,
empty and long repeated fields, nested messages) and built twice, as the
port's `proto.wire` message and as the JAX package's `_pb2` message. The
port's bytes must equal `SerializeToString(deterministic=True)` exactly,
and protobuf's bytes (also in unpacked forms and with unknown fields) must
decode to the same values.
"""

import math
import struct

import numpy as np
import pytest
from google.protobuf import descriptor as pb_descriptor

from putting_dune_torch.proto import wire
from putting_dune_tpu.proto import putting_dune_tpu_pb2 as pb

CASES = 200

_PB_TYPES = {
    pb_descriptor.FieldDescriptor.TYPE_INT32: wire.INT32,
    pb_descriptor.FieldDescriptor.TYPE_INT64: wire.INT64,
    pb_descriptor.FieldDescriptor.TYPE_UINT32: wire.UINT32,
    pb_descriptor.FieldDescriptor.TYPE_UINT64: wire.UINT64,
    pb_descriptor.FieldDescriptor.TYPE_BOOL: wire.BOOL,
    pb_descriptor.FieldDescriptor.TYPE_FLOAT: wire.FLOAT,
    pb_descriptor.FieldDescriptor.TYPE_DOUBLE: wire.DOUBLE,
    pb_descriptor.FieldDescriptor.TYPE_STRING: wire.STRING,
    pb_descriptor.FieldDescriptor.TYPE_BYTES: wire.BYTES,
    pb_descriptor.FieldDescriptor.TYPE_MESSAGE: wire.MESSAGE,
}


def _pb_class(cls):
  if cls is wire.TensorShapeProtoCompatDim:
    return pb.TensorShapeProtoCompat.Dim
  return getattr(pb, cls.__name__)


def _is_map(fd) -> bool:
  return (fd.type == fd.TYPE_MESSAGE
          and fd.message_type.GetOptions().map_entry)


def test_schema_matches_the_jax_package_descriptor():
  names = {cls.__name__ for cls in wire.MESSAGES}
  assert names - {'TensorShapeProtoCompatDim'} == set(
      pb.DESCRIPTOR.message_types_by_name)
  for cls in wire.MESSAGES:
    descriptor = _pb_class(cls).DESCRIPTOR
    assert [f.number for f in cls.FIELDS] == [
        f.number for f in descriptor.fields]
    for field, fd in zip(cls.FIELDS, descriptor.fields):
      assert field.name == fd.name
      if _is_map(fd):
        value = fd.message_type.fields_by_name['value']
        assert field.map_value[0] == _PB_TYPES[value.type]
        assert field.map_value[1].__name__ == value.message_type.name
        continue
      assert field.kind == _PB_TYPES[fd.type], fd.full_name
      assert field.repeated == (fd.label == fd.LABEL_REPEATED), fd.full_name
      assert field.packed == bool(fd.is_packed), fd.full_name
      if field.kind == wire.MESSAGE:
        name = fd.message_type.name
        assert field.message.__name__ == (
            'TensorShapeProtoCompatDim' if name == 'Dim' else name)


# --- random messages ---------------------------------------------------------

_FLOATS = (0.0, -0.0, 1.0, -1.5, float('nan'), float('inf'), float('-inf'),
           1e-40, 3.4e38, -2.5e-7)
_INT_EDGES = {
    wire.INT32: (0, -1, 1, -2**31, 2**31 - 1, 127, 128, -128),
    wire.INT64: (0, -1, 1, -2**63, 2**63 - 1, 300, -300),
    wire.UINT32: (0, 1, 2**32 - 1, 127, 128),
    wire.UINT64: (0, 1, 2**64 - 1, 2**63, 16384),
}
_INT_RANGE = {wire.INT32: (-2**31, 2**31), wire.INT64: (-2**63, 2**63),
              wire.UINT32: (0, 2**32), wire.UINT64: (0, 2**64)}


def _scalar(rng, kind):
  if kind == wire.BOOL:
    return bool(rng.integers(2))
  if kind in _INT_RANGE:
    if rng.random() < 0.3:
      edges = _INT_EDGES[kind]
      return int(edges[rng.integers(len(edges))])
    lo, hi = _INT_RANGE[kind]
    bits = int(rng.integers(1, 65))
    value = int.from_bytes(rng.bytes(8), 'little') % (1 << bits)
    return lo + value % (hi - lo) if lo else value % hi
  if kind in (wire.FLOAT, wire.DOUBLE):
    if rng.random() < 0.3:
      return _FLOATS[rng.integers(len(_FLOATS))]
    value = float(rng.normal() * 10.0 ** rng.integers(-6, 7))
    return value
  if kind == wire.STRING:
    n = int(rng.integers(0, 8))
    return ''.join(chr(int(c)) for c in rng.choice(
        [65, 97, 48, 0x3b1, 0x4e2d, 0x1f600, 32, 0], size=n))
  if kind == wire.BYTES:
    return rng.bytes(int(rng.integers(0, 12)))
  raise AssertionError(kind)


def _spec(rng, cls, depth=0):
  """{name: value} of one random message; nested messages as (cls, spec)."""
  spec = {}
  for field in cls.FIELDS:
    if rng.random() < 0.3:
      continue  # unset
    deep = depth >= 3
    if field.map_value is not None:
      kind, message = field.map_value
      spec[field.name] = {
          _scalar(rng, wire.STRING): (
              (message, {} if deep else _spec(rng, message, depth + 1))
              if kind == wire.MESSAGE else _scalar(rng, kind))
          for _ in range(int(rng.integers(0, 4)))}
    elif field.repeated:
      n = int(rng.integers(0, 6 if rng.random() < 0.8 else 40))
      if field.kind == wire.MESSAGE:
        spec[field.name] = [
            (field.message, {} if deep else _spec(rng, field.message,
                                                  depth + 1))
            for _ in range(min(n, 4))]
      else:
        spec[field.name] = [_scalar(rng, field.kind) for _ in range(n)]
    elif field.kind == wire.MESSAGE:
      spec[field.name] = (field.message, {} if deep else _spec(
          rng, field.message, depth + 1))
    else:
      spec[field.name] = _scalar(rng, field.kind)
  return spec


def _port(cls, spec):
  def value(v):
    if isinstance(v, tuple):
      return _port(*v)
    if isinstance(v, list):
      return [value(x) for x in v]
    if isinstance(v, dict):
      return {k: value(x) for k, x in v.items()}
    return v
  return cls(**{k: value(v) for k, v in spec.items()})


def _protobuf(cls, spec):
  msg = _pb_class(cls)()
  for name, v in spec.items():
    if isinstance(v, tuple):
      getattr(msg, name).SetInParent()
      getattr(msg, name).CopyFrom(_protobuf(*v))
    elif isinstance(v, dict):
      target = getattr(msg, name)
      for key, item in v.items():
        if isinstance(item, tuple):
          target[key].CopyFrom(_protobuf(*item))
        else:
          target[key] = item
    elif isinstance(v, list):
      target = getattr(msg, name)
      for item in v:
        if isinstance(item, tuple):
          target.add().CopyFrom(_protobuf(*item))
        else:
          target.append(item)
    else:
      setattr(msg, name, v)
  return msg


def _same(a, b) -> bool:
  if isinstance(a, float) and isinstance(b, float):
    return (math.isnan(a) and math.isnan(b)) or (
        a == b and math.copysign(1, a) == math.copysign(1, b))
  return a == b


def _assert_values(port_msg, pb_msg):
  """Every field of the port's decoded message equals protobuf's."""
  for field in type(port_msg).FIELDS:
    got, want = getattr(port_msg, field.name), getattr(pb_msg, field.name)
    if field.map_value is not None:
      assert sorted(got) == sorted(want), field.name
      for key in got:
        if field.map_value[0] == wire.MESSAGE:
          _assert_values(got[key], want[key])
        else:
          assert _same(got[key], want[key])
    elif field.repeated:
      assert len(got) == len(want), field.name
      for g, w in zip(got, want):
        if field.kind == wire.MESSAGE:
          _assert_values(g, w)
        else:
          assert _same(g, w), (field.name, g, w)
    else:
      assert port_msg.HasField(field.name) == pb_msg.HasField(field.name), \
          field.name
      if field.kind == wire.MESSAGE:
        _assert_values(got, want)
      else:
        assert _same(got, want), (field.name, got, want)


@pytest.mark.parametrize('cls', wire.MESSAGES, ids=lambda c: c.__name__)
def test_bytes_equal_deterministic_protobuf_and_decode_back(cls):
  rng = np.random.default_rng(sum(map(ord, cls.__name__)))
  for _ in range(CASES):
    spec = _spec(rng, cls)
    port_msg = _port(cls, spec)
    pb_msg = _protobuf(cls, spec)
    want = pb_msg.SerializeToString(deterministic=True)
    assert port_msg.SerializeToString() == want
    decoded = cls.FromString(want)
    _assert_values(decoded, pb_msg)
    assert decoded.SerializeToString() == want
    # Protobuf's own bytes in whatever order it keeps its maps.
    _assert_values(cls.FromString(pb_msg.SerializeToString()), pb_msg)


def test_negative_int32_is_ten_bytes_and_zigzag_free():
  raw = wire.Atom(atomic_number=-1).SerializeToString()
  assert raw == pb.Atom(atomic_number=-1).SerializeToString()
  assert len(raw) == 11


def test_floats_round_to_float32_as_protobuf_stores_them():
  msg = wire.Point2D(x=0.1)
  assert msg.x == pb.Point2D(x=0.1).x == struct.unpack(
      '<f', struct.pack('<f', 0.1))[0]


def test_unset_optional_stays_unset_and_a_set_default_is_written():
  unset = wire.BeamControl(dwell_time_seconds=1.0)
  assert not unset.HasField('current_na') and unset.current_na == 0.0
  zero = wire.BeamControl(dwell_time_seconds=1.0, current_na=0.0)
  assert zero.HasField('current_na')
  for msg, want in ((unset, pb.BeamControl(dwell_time_seconds=1.0)),
                    (zero, pb.BeamControl(dwell_time_seconds=1.0,
                                          current_na=0.0))):
    assert msg.SerializeToString() == want.SerializeToString()
  assert not wire.BeamControl.FromString(
      unset.SerializeToString()).HasField('current_na')


def test_unpacked_and_packed_forms_both_parse():
  # NDArray.shape is unpacked in proto2; protobuf's parser takes it packed.
  shape = [3, 0, 2**40]
  unpacked = pb.NDArray(dtype='<f4', shape=shape).SerializeToString()
  packed_body = b''.join(wire.encode_varint(s) for s in shape)
  packed = (b'\x0a\x03<f4' + b'\x12' + wire.encode_varint(len(packed_body))
            + packed_body)
  assert pb.NDArray.FromString(packed).shape == shape
  for raw in (unpacked, packed):
    assert wire.NDArray.FromString(raw).shape == shape
  # TensorProtoCompat.float_val is packed; one tag per value parses too.
  values = [1.5, -2.0, float('inf')]
  loose = b''.join(b'\x2d' + struct.pack('<f', v) for v in values)
  assert list(pb.TensorProtoCompat.FromString(loose).float_val) == values
  assert wire.TensorProtoCompat.FromString(loose).float_val == values
  assert wire.TensorProtoCompat(float_val=values).SerializeToString() == (
      pb.TensorProtoCompat(float_val=values).SerializeToString())


def test_unknown_fields_and_wrong_wire_types_are_kept():
  # Field 9 is unknown to Point2D; field 1 arrives as a varint where the
  # schema says float (protobuf keeps both as unknown fields).
  raw = (b'\x0d' + struct.pack('<f', 2.5) + b'\x48\x96\x01' + b'\x08\x07'
         + b'\x4a\x02hi')
  want = pb.Point2D.FromString(raw)
  got = wire.Point2D.FromString(raw)
  _assert_values(got, want)
  assert got.SerializeToString() == want.SerializeToString()
  # A TensorProto payload never sniffs as an NDArray: its dtype field is
  # a varint, so NDArray.dtype stays unset.
  tp = pb.TensorProtoCompat(dtype=1, tensor_content=b'1234')
  nd = wire.NDArray.FromString(tp.SerializeToString())
  assert not nd.HasField('dtype')
  assert not pb.NDArray.FromString(tp.SerializeToString()).HasField('dtype')


def test_submessages_merge_and_last_scalar_wins():
  first = pb.Atom(atomic_number=6, position=pb.Point2D(x=1.0))
  second = pb.Atom(atomic_number=14, position=pb.Point2D(y=2.0))
  raw = first.SerializeToString() + second.SerializeToString()
  want = pb.Atom.FromString(raw)
  got = wire.Atom.FromString(raw)
  _assert_values(got, want)
  assert got.position.x == 1.0 and got.position.y == 2.0


def test_map_entries_sorted_by_key():
  nd = wire.NDArray(dtype='<i4', shape=[1], data=b'\0\0\0\0')
  msg = wire.ArrayExample(arrays={'z': nd, 'a': nd, 'm': nd})
  want = pb.ArrayExample()
  for key in ('z', 'a', 'm'):
    want.arrays[key].CopyFrom(pb.NDArray(dtype='<i4', shape=[1],
                                         data=b'\0\0\0\0'))
  assert msg.SerializeToString() == want.SerializeToString(deterministic=True)


@pytest.mark.parametrize('raw', [b'\x0a\x05ab', b'\x08', b'\x0d\x00',
                                 b'\x00\x01', b'\x0f'])
def test_garbage_raises_in_both(raw):
  with pytest.raises(Exception):
    pb.NDArray.FromString(raw)
  with pytest.raises(wire.DecodeError):
    wire.NDArray.FromString(raw)


def test_type_and_range_checks():
  with pytest.raises(ValueError):
    wire.Atom(atomic_number=2**31)
  with pytest.raises(TypeError):
    wire.Atom(atomic_number=1.5)
  with pytest.raises(TypeError):
    wire.Atom(position=wire.Atom())
  with pytest.raises(AttributeError):
    wire.Atom(mass=1)


# --- the atomic-grid fast paths of microscope_data ---------------------------


@pytest.mark.parametrize('seed', range(6))
def test_atomic_grid_fast_path_equals_the_codec_and_protobuf(seed):
  from putting_dune_torch import microscope_data as t_md
  from putting_dune_tpu import microscope_data as j_md

  rng = np.random.default_rng(seed)
  n = int(rng.integers(0, 300))
  positions = rng.normal(size=(n, 2)) * 10.0 ** rng.integers(-3, 4)
  numbers = rng.choice([6, 14, 0, 127], size=n)
  if seed >= 3 and n:  # numbers that need more than one varint byte
    numbers[rng.integers(n)] = [128, -1, 2**31 - 1][seed - 3]
  if n:
    positions[0] = [float('inf'), -0.0]
  grid = t_md.AtomicGrid(positions, numbers)
  fast = grid.to_proto_bytes()
  assert fast == grid.to_proto().SerializeToString()
  assert fast == j_md.AtomicGrid(positions, numbers).to_proto() \
      .SerializeToString(deterministic=True)
  back = t_md.AtomicGrid.from_proto_bytes(fast)
  slow = t_md.AtomicGrid.from_proto(wire.AtomicGrid.FromString(fast))
  np.testing.assert_array_equal(back.atom_positions, slow.atom_positions)
  np.testing.assert_array_equal(back.atomic_numbers, slow.atomic_numbers)
  assert back.atomic_numbers.dtype == np.int32
  # A parsed observation hands its grid's bytes out unparsed.
  obs = wire.MicroscopeObservation(grid=wire.encoded(wire.AtomicGrid, fast))
  parsed = wire.MicroscopeObservation.FromString(obs.SerializeToString())
  assert parsed.raw('grid') == fast
  assert len(parsed.grid.atoms) == n and parsed.raw('fov') == b''
