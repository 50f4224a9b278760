"""A protobuf wire codec of the port's own for `putting_dune_torch.proto`.

The port reads and writes the JAX package's record files without the
`protobuf` package. Each message of the schema is a small class below whose
`FIELDS` name its fields (number, name, type, label, packing), and one
engine encodes and decodes them on the protobuf wire:

  * varints; `int32` / `int64` negatives as 10-byte two's complement;
    `bool`; `uint32` / `uint64`;
  * `float` as fixed32 (a value is rounded to float32 when it is set, as
    protobuf stores it) and `double` as fixed64; `fixed32` / `fixed64`
    unsigned integers and zigzagged `sint64` varints (for TensorFlow's
    messages, `proto/tf_wire.py`);
  * length-delimited `string`, `bytes` and submessages;
  * proto2 `optional` presence: a field set to its default is present and
    written, an unset one is neither (`HasField`);
  * repeated scalars packed where the schema says `[packed = true]` and
    one tag per element elsewhere; the parser takes either form;
  * `map<string, X>` fields as their entry messages (key 1, value 2);
  * unknown fields (and known numbers on another wire type) are kept as
    raw bytes and written back after the known ones;
  * a parsed singular submessage is kept as its bytes until it is read
    (`raw(name)` hands them out unparsed), and `encoded(cls, data)` sets
    one from bytes already encoded: the fast paths of `microscope_data`
    move atomic grids through these without an object per atom.

`SerializeToString()` writes the known fields in field-number order and
map entries sorted by key as protobuf's deterministic mode sorts them (by
the keys' UTF-8 bytes, and of two keys one of which begins the other, the
longer first): the bytes of protobuf's `SerializeToString(deterministic=
True)`.
"""

from __future__ import annotations

import functools
import struct
from typing import Any, Dict, List, NamedTuple, Tuple


class DecodeError(ValueError):
  """The bytes do not parse as the message."""


# Field types.
INT32, INT64, UINT32, UINT64 = 'int32', 'int64', 'uint32', 'uint64'
BOOL, FLOAT, DOUBLE = 'bool', 'float', 'double'
FIXED32, FIXED64, SINT64 = 'fixed32', 'fixed64', 'sint64'
STRING, BYTES, MESSAGE = 'string', 'bytes', 'message'

_VARINT_TYPES = (INT32, INT64, UINT32, UINT64, BOOL, SINT64)
_WT_VARINT, _WT_FIXED64, _WT_DELIMITED, _WT_START_GROUP, _WT_END_GROUP, \
    _WT_FIXED32 = 0, 1, 2, 3, 4, 5
_WIRE_TYPE = {INT32: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: 0,
              FLOAT: 5, DOUBLE: 1, STRING: 2, BYTES: 2, MESSAGE: 2,
              FIXED32: 5, FIXED64: 1, SINT64: 0}
_DEFAULTS = {INT32: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: False,
             FLOAT: 0.0, DOUBLE: 0.0, STRING: '', BYTES: b'',
             FIXED32: 0, FIXED64: 0, SINT64: 0}
_M64 = (1 << 64) - 1


class Field(NamedTuple):
  number: int
  name: str
  kind: str
  repeated: bool = False
  packed: bool = False
  message: Any = None  # the submessage class (kind MESSAGE)
  map_value: Any = None  # (kind, message class or None) of a map<string, X>


# --- scalars -----------------------------------------------------------------


def encode_varint(value: int) -> bytes:
  value &= _M64
  out = bytearray()
  while value > 0x7F:
    out.append((value & 0x7F) | 0x80)
    value >>= 7
  out.append(value)
  return bytes(out)


def read_varint(data, pos: int) -> Tuple[int, int]:
  result = shift = 0
  while True:
    if pos >= len(data):
      raise DecodeError('truncated varint')
    byte = data[pos]
    pos += 1
    result |= (byte & 0x7F) << shift
    if byte < 0x80:
      return result & _M64, pos
    shift += 7
    if shift >= 70:
      raise DecodeError('varint longer than 10 bytes')


def _to_float32(value) -> float:
  value = float(value)
  try:
    return struct.unpack('<f', struct.pack('<f', value))[0]
  except OverflowError:
    return float('inf') if value > 0 else float('-inf')


def _check_int(kind: str, value) -> int:
  if isinstance(value, float) or not hasattr(value, '__index__'):
    raise TypeError(f'{kind} field takes an integer, got {value!r}')
  value = int(value)
  lo, hi = {INT32: (-2**31, 2**31 - 1), INT64: (-2**63, 2**63 - 1),
            SINT64: (-2**63, 2**63 - 1), UINT32: (0, 2**32 - 1),
            UINT64: (0, 2**64 - 1), FIXED32: (0, 2**32 - 1),
            FIXED64: (0, 2**64 - 1)}[kind]
  if not lo <= value <= hi:
    raise ValueError(f'value {value} out of range for {kind}')
  return value


def _coerce(kind: str, value):
  """A scalar as the field stores it (float32 rounding, type checks)."""
  if kind == FLOAT:
    return _to_float32(value)
  if kind == DOUBLE:
    return float(value)
  if kind == BOOL:
    return bool(value)
  if kind == STRING:
    if isinstance(value, bytes):
      value = value.decode('utf-8')
    if not isinstance(value, str):
      raise TypeError(f'string field takes str, got {type(value)}')
    return value
  if kind == BYTES:
    if isinstance(value, str):
      value = value.encode('utf-8')
    return bytes(value)
  return _check_int(kind, value)


def _signed(value: int, bits: int) -> int:
  value &= (1 << bits) - 1
  return value - (1 << bits) if value >> (bits - 1) else value


def _from_varint(kind: str, value: int):
  if kind == INT32:
    return _signed(value, 32)
  if kind == INT64:
    return _signed(value, 64)
  if kind == UINT32:
    return value & 0xFFFFFFFF
  if kind == BOOL:
    return value != 0
  if kind == SINT64:
    return (value >> 1) ^ -(value & 1)
  return value


# struct formats of the fixed-width kinds.
_FIXED = {FLOAT: 'f', DOUBLE: 'd', FIXED32: 'I', FIXED64: 'Q'}


def _encode_scalar(kind: str, value) -> bytes:
  if kind == SINT64:
    value = int(value)
    return encode_varint((value << 1) ^ (value >> 63))
  if kind in _VARINT_TYPES:
    return encode_varint(int(value))
  if kind in _FIXED:
    return struct.pack('<' + _FIXED[kind], value)
  data = value.encode('utf-8') if kind == STRING else value
  return encode_varint(len(data)) + data


def _encode_packed(kind: str, values) -> bytes:
  if kind in _FIXED:
    return struct.pack(f'<{len(values)}{_FIXED[kind]}', *values)
  return b''.join(_encode_scalar(kind, v) for v in values)


def _decode_packed(kind: str, data) -> list:
  if kind in _FIXED:
    size = struct.calcsize(_FIXED[kind])
    if len(data) % size:
      raise DecodeError(f'packed {kind} field of a length not a multiple '
                        f'of {size}')
    return list(struct.unpack(f'<{len(data) // size}{_FIXED[kind]}', data))
  out, pos = [], 0
  while pos < len(data):
    value, pos = read_varint(data, pos)
    out.append(_from_varint(kind, value))
  return out


def _skip_field(data, pos: int, wire_type: int, number: int) -> int:
  """The position after one field's value (groups skipped whole)."""
  if wire_type == _WT_VARINT:
    return read_varint(data, pos)[1]
  if wire_type == _WT_FIXED64:
    pos += 8
  elif wire_type == _WT_FIXED32:
    pos += 4
  elif wire_type == _WT_DELIMITED:
    length, pos = read_varint(data, pos)
    pos += length
  elif wire_type == _WT_START_GROUP:
    while True:
      if pos >= len(data):
        raise DecodeError('unterminated group')
      tag, pos = read_varint(data, pos)
      if tag & 7 == _WT_END_GROUP:
        if tag >> 3 != number:
          raise DecodeError('mismatched end of group')
        return pos
      pos = _skip_field(data, pos, tag & 7, tag >> 3)
  else:
    raise DecodeError(f'invalid wire type {wire_type}')
  if pos > len(data):
    raise DecodeError('truncated field')
  return pos


def _key_order(a: str, b: str) -> int:
  a, b = a.encode('utf-8'), b.encode('utf-8')
  n = min(len(a), len(b))
  if a[:n] != b[:n]:
    return -1 if a[:n] < b[:n] else 1
  return len(b) - len(a)


_MAP_KEY = functools.cmp_to_key(_key_order)


# --- messages ----------------------------------------------------------------


class _Lazy:
  """A singular submessage held as its bytes: parsed on first access.
  `canonical` bytes (from `encoded`) are written back as they are; parsed
  ones are parsed and re-serialized when written, as protobuf would."""

  __slots__ = ('cls', 'data', 'canonical')

  def __init__(self, cls, data: bytes, canonical: bool):
    self.cls, self.data, self.canonical = cls, data, canonical

  def parse(self) -> 'Message':
    return self.cls.FromString(self.data)


def encoded(cls, data: bytes) -> _Lazy:
  """A submessage value of type `cls` given as bytes that are already its
  canonical serialization (what `cls(...).SerializeToString()` writes),
  for fast paths that encode a large submessage without its objects."""
  return _Lazy(cls, bytes(data), True)


class Message:
  """The base of the schema's messages: fields as attributes, with proto2
  presence. An unset scalar reads as its default, an unset submessage as
  an empty message (not stored), a repeated field as a list and a map as
  a dict, both stored on first access so that appends persist."""

  FIELDS: Tuple[Field, ...] = ()
  _by_name: Dict[str, Field] = {}
  _by_number: Dict[int, Field] = {}

  __slots__ = ('_values', '_unknown')

  def __init_subclass__(cls, **kwargs):
    super().__init_subclass__(**kwargs)
    cls._by_name = {f.name: f for f in cls.FIELDS}
    cls._by_number = {f.number: f for f in cls.FIELDS}
    cls._ordered = tuple(sorted(cls.FIELDS, key=lambda f: f.number))

  def __init__(self, **kwargs):
    object.__setattr__(self, '_values', {})
    object.__setattr__(self, '_unknown', [])
    for name, value in kwargs.items():
      if value is not None:
        setattr(self, name, value)

  # -- field access -----------------------------------------------------------

  def _field(self, name: str) -> Field:
    try:
      return self._by_name[name]
    except KeyError:
      raise AttributeError(
          f'{type(self).__name__} has no field {name!r}') from None

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    field = self._field(name)
    values = self._values
    if name in values:
      value = values[name]
      if type(value) is _Lazy:
        value = values[name] = value.parse()
      return value
    if field.map_value is not None:
      values[name] = {}
      return values[name]
    if field.repeated:
      values[name] = []
      return values[name]
    if field.kind == MESSAGE:
      return field.message()
    return _DEFAULTS[field.kind]

  def __setattr__(self, name, value):
    field = self._field(name)
    if value is None:
      self._values.pop(name, None)
      return
    if field.map_value is not None:
      kind, message = field.map_value
      value = {_coerce(STRING, k): (v if kind == MESSAGE else _coerce(kind, v))
               for k, v in dict(value).items()}
      if kind == MESSAGE and not all(isinstance(v, message)
                                     for v in value.values()):
        raise TypeError(f'{name}: map values must be {message.__name__}')
    elif field.repeated:
      if field.kind == MESSAGE:
        value = list(value)
        if not all(isinstance(v, field.message) for v in value):
          raise TypeError(f'{name}: elements must be {field.message.__name__}')
      else:
        value = [_coerce(field.kind, v) for v in value]
    elif field.kind == MESSAGE:
      if type(value) is _Lazy:
        if value.cls is not field.message:
          raise TypeError(f'{name}: expected {field.message.__name__}')
      elif not isinstance(value, field.message):
        raise TypeError(f'{name}: expected {field.message.__name__}, got '
                        f'{type(value).__name__}')
    else:
      value = _coerce(field.kind, value)
    self._values[name] = value

  def HasField(self, name: str) -> bool:  # pylint: disable=invalid-name
    field = self._field(name)
    if field.repeated or field.map_value is not None:
      raise ValueError(f'{name} is repeated: it has no presence')
    return name in self._values

  def raw(self, name: str) -> bytes:
    """The serialized bytes of the singular submessage `name` (b'' when
    unset): the bytes it was parsed from while it has not been read."""
    field = self._field(name)
    if field.kind != MESSAGE or field.repeated or field.map_value is not None:
      raise ValueError(f'{name} is not a singular submessage')
    value = self._values.get(name)
    if value is None:
      return b''
    if type(value) is _Lazy:
      return value.data
    return value.SerializeToString()

  def ListFields(self) -> List[Tuple[str, Any]]:  # pylint: disable=invalid-name
    """(name, value) of every present field (non-empty repeated), in field
    number order."""
    out = []
    for field in self._ordered:
      if field.name in self._values:
        value = getattr(self, field.name)
        if (field.repeated or field.map_value is not None) and not value:
          continue
        out.append((field.name, value))
    return out

  def __eq__(self, other) -> bool:
    if type(other) is not type(self):
      return NotImplemented
    return self.SerializeToString() == other.SerializeToString()

  def __repr__(self) -> str:
    inner = ', '.join(f'{k}={v!r}' for k, v in self.ListFields())
    return f'{type(self).__name__}({inner})'

  # -- encoding ---------------------------------------------------------------

  def SerializeToString(self) -> bytes:  # pylint: disable=invalid-name
    out: List[bytes] = []
    self._encode(out)
    return b''.join(out)

  def _encode(self, out: List[bytes]) -> None:
    values = self._values
    for field in self._ordered:
      if field.name not in values:
        continue
      value = values[field.name]
      number, kind = field.number, field.kind
      if field.map_value is not None:
        value_kind, _ = field.map_value
        tag = encode_varint(number << 3 | _WT_DELIMITED)
        for key in sorted(value, key=_MAP_KEY):
          entry = [encode_varint(1 << 3 | _WT_DELIMITED),
                   _encode_scalar(STRING, key)]
          item = value[key]
          if value_kind == MESSAGE:
            body = item.SerializeToString()
            entry += [encode_varint(2 << 3 | _WT_DELIMITED),
                      encode_varint(len(body)), body]
          else:
            entry += [encode_varint(2 << 3 | _WIRE_TYPE[value_kind]),
                      _encode_scalar(value_kind, item)]
          entry = b''.join(entry)
          out += [tag, encode_varint(len(entry)), entry]
      elif field.repeated:
        if not value:
          continue
        if field.packed:
          body = _encode_packed(kind, value)
          out += [encode_varint(number << 3 | _WT_DELIMITED),
                  encode_varint(len(body)), body]
        elif kind == MESSAGE:
          tag = encode_varint(number << 3 | _WT_DELIMITED)
          for item in value:
            body = item.SerializeToString()
            out += [tag, encode_varint(len(body)), body]
        else:
          tag = encode_varint(number << 3 | _WIRE_TYPE[kind])
          for item in value:
            out += [tag, _encode_scalar(kind, item)]
      elif kind == MESSAGE:
        if type(value) is _Lazy:
          body = (value.data if value.canonical
                  else value.parse().SerializeToString())
        else:
          body = value.SerializeToString()
        out += [encode_varint(number << 3 | _WT_DELIMITED),
                encode_varint(len(body)), body]
      else:
        out += [encode_varint(number << 3 | _WIRE_TYPE[kind]),
                _encode_scalar(kind, value)]
    out.extend(self._unknown)

  # -- decoding ---------------------------------------------------------------

  @classmethod
  def FromString(cls, data) -> 'Message':  # pylint: disable=invalid-name
    msg = cls()
    msg.MergeFromString(data)
    return msg

  def MergeFromString(self, data) -> int:  # pylint: disable=invalid-name
    """Parses `data` into this message as protobuf merges: the last value
    of a singular scalar wins, submessages merge, repeated fields append.
    Returns the number of bytes read."""
    data = bytes(data)
    pos, end = 0, len(data)
    values = self._values
    while pos < end:
      start = pos
      tag, pos = read_varint(data, pos)
      number, wire_type = tag >> 3, tag & 7
      if number == 0:
        raise DecodeError('field number 0')
      field = self._by_number.get(number)
      expected = None if field is None else _WIRE_TYPE[field.kind]
      packed_form = (field is not None and field.repeated
                     and field.kind not in (STRING, BYTES, MESSAGE)
                     and wire_type == _WT_DELIMITED)
      if field is None or (wire_type != expected and not packed_form):
        pos = _skip_field(data, pos, wire_type, number)
        self._unknown.append(data[start:pos])
        continue
      name, kind = field.name, field.kind
      if wire_type == _WT_DELIMITED:
        length, pos = read_varint(data, pos)
        if pos + length > end:
          raise DecodeError(f'{type(self).__name__}.{name}: truncated')
        chunk = data[pos:pos + length]
        pos += length
        if packed_form:
          values.setdefault(name, []).extend(_decode_packed(kind, chunk))
        elif field.map_value is not None:
          key, item = self._decode_map_entry(field, chunk)
          values.setdefault(name, {})[key] = item
        elif kind == MESSAGE:
          if field.repeated:
            values.setdefault(name, []).append(field.message.FromString(chunk))
          elif name in values:
            getattr(self, name).MergeFromString(chunk)
          else:
            # Parsed when first read (`raw` gives the bytes unparsed), so
            # a fault inside it raises DecodeError then.
            values[name] = _Lazy(field.message, chunk, False)
        else:
          value = chunk.decode('utf-8') if kind == STRING else chunk
          if field.repeated:
            values.setdefault(name, []).append(value)
          else:
            values[name] = value
        continue
      if wire_type == _WT_VARINT:
        raw, pos = read_varint(data, pos)
        value = _from_varint(kind, raw)
      elif wire_type == _WT_FIXED32:
        if pos + 4 > end:
          raise DecodeError('truncated fixed32')
        value = struct.unpack_from('<' + _FIXED.get(kind, 'f'), data, pos)[0]
        pos += 4
      else:
        if pos + 8 > end:
          raise DecodeError('truncated fixed64')
        value = struct.unpack_from('<' + _FIXED.get(kind, 'd'), data, pos)[0]
        pos += 8
      if field.repeated:
        values.setdefault(name, []).append(value)
      else:
        values[name] = value
    if pos != end:
      raise DecodeError('field ran past the end of the message')
    return end

  @staticmethod
  def _decode_map_entry(field: Field, data: bytes):
    value_kind, value_message = field.map_value
    key, item = '', None
    pos = 0
    while pos < len(data):
      tag, pos = read_varint(data, pos)
      number, wire_type = tag >> 3, tag & 7
      if number == 1 and wire_type == _WT_DELIMITED:
        length, pos = read_varint(data, pos)
        key = data[pos:pos + length].decode('utf-8')
        pos += length
      elif number == 2 and wire_type == _WIRE_TYPE[value_kind]:
        if value_kind == MESSAGE:
          length, pos = read_varint(data, pos)
          item = value_message.FromString(data[pos:pos + length])
          pos += length
        elif wire_type == _WT_DELIMITED:
          length, pos = read_varint(data, pos)
          chunk = data[pos:pos + length]
          item = chunk.decode('utf-8') if value_kind == STRING else chunk
          pos += length
        elif wire_type == _WT_VARINT:
          raw, pos = read_varint(data, pos)
          item = _from_varint(value_kind, raw)
        elif wire_type == _WT_FIXED32:
          item = struct.unpack_from('<' + _FIXED.get(value_kind, 'f'), data,
                                    pos)[0]
          pos += 4
        else:
          item = struct.unpack_from('<' + _FIXED.get(value_kind, 'd'), data,
                                    pos)[0]
          pos += 8
      else:
        pos = _skip_field(data, pos, wire_type, number)
    if item is None:
      item = value_message() if value_kind == MESSAGE else _DEFAULTS[value_kind]
    return key, item


def _f(number, name, kind, *, repeated=False, packed=False, message=None,
       map_value=None) -> Field:
  return Field(number, name, kind, repeated, packed, message, map_value)


# --- the schema (proto/putting_dune_torch.proto) -----------------------------


class Point2D(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'x', FLOAT), _f(2, 'y', FLOAT))


class Atom(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'atomic_number', INT32),
            _f(2, 'position', MESSAGE, message=Point2D))


class AtomicGrid(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'atoms', MESSAGE, repeated=True, message=Atom),)


class BeamControl(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'position', MESSAGE, message=Point2D),
            _f(2, 'dwell_time_seconds', FLOAT),
            _f(3, 'voltage_kv', FLOAT),
            _f(4, 'current_na', FLOAT))


class FieldOfView(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'lower_left_angstroms', MESSAGE, message=Point2D),
            _f(2, 'upper_right_angstroms', MESSAGE, message=Point2D))


class NDArray(Message):
  """Dense ndarray: numpy dtype string (e.g. '<f4'), shape, raw bytes.
  `shape` is unpacked: proto2 packs only where the schema says so."""
  __slots__ = ()
  FIELDS = (_f(1, 'dtype', STRING),
            _f(2, 'shape', INT64, repeated=True),
            _f(3, 'data', BYTES))


class TensorShapeProtoCompatDim(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'size', INT64), _f(2, 'name', STRING))


class TensorShapeProtoCompat(Message):
  __slots__ = ()
  Dim = TensorShapeProtoCompatDim
  FIELDS = (_f(2, 'dim', MESSAGE, repeated=True,
               message=TensorShapeProtoCompatDim),
            _f(3, 'unknown_rank', BOOL))


class TensorProtoCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'dtype', INT32),
            _f(2, 'tensor_shape', MESSAGE, message=TensorShapeProtoCompat),
            _f(3, 'version_number', INT32),
            _f(4, 'tensor_content', BYTES),
            _f(5, 'float_val', FLOAT, repeated=True, packed=True),
            _f(6, 'double_val', DOUBLE, repeated=True, packed=True),
            _f(7, 'int_val', INT32, repeated=True, packed=True),
            _f(8, 'string_val', BYTES, repeated=True),
            _f(10, 'int64_val', INT64, repeated=True, packed=True),
            _f(11, 'bool_val', BOOL, repeated=True, packed=True),
            _f(13, 'half_val', INT32, repeated=True, packed=True),
            _f(16, 'uint32_val', UINT32, repeated=True, packed=True),
            _f(17, 'uint64_val', UINT64, repeated=True, packed=True))


class MicroscopeObservation(Message):
  """Image fields hold a raw NDArray or tensorflow.TensorProto submessage
  (io/tensorproto.py sniffs which)."""
  __slots__ = ()
  FIELDS = (_f(1, 'grid', MESSAGE, message=AtomicGrid),
            _f(2, 'fov', MESSAGE, message=FieldOfView),
            _f(3, 'controls', MESSAGE, repeated=True, message=BeamControl),
            _f(4, 'elapsed_time_seconds', FLOAT),
            _f(5, 'image', BYTES),
            _f(6, 'label_image', BYTES))


class Trajectory(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'observations', MESSAGE, repeated=True,
               message=MicroscopeObservation),)


class Transition(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'grid_before', MESSAGE, message=AtomicGrid),
            _f(2, 'grid_after', MESSAGE, message=AtomicGrid),
            _f(3, 'fov_before', MESSAGE, message=FieldOfView),
            _f(4, 'fov_after', MESSAGE, message=FieldOfView),
            _f(5, 'controls', MESSAGE, repeated=True, message=BeamControl),
            _f(6, 'image_before', BYTES),
            _f(7, 'image_after', BYTES),
            _f(8, 'label_image_before', BYTES),
            _f(9, 'label_image_after', BYTES))


class Drift(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'jitter', MESSAGE, repeated=True, message=Point2D),
            _f(2, 'drift', MESSAGE, message=Point2D))


class LabeledAlignmentTrajectory(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'trajectory', MESSAGE, message=Trajectory),
            _f(2, 'drifts', MESSAGE, repeated=True, message=Drift))


class ArrayExample(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'arrays', MESSAGE, map_value=(MESSAGE, NDArray)),)


class BytesListCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'value', BYTES, repeated=True),)


class FloatListCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'value', FLOAT, repeated=True, packed=True),)


class Int64ListCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'value', INT64, repeated=True, packed=True),)


class FeatureCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'bytes_list', MESSAGE, message=BytesListCompat),
            _f(2, 'float_list', MESSAGE, message=FloatListCompat),
            _f(3, 'int64_list', MESSAGE, message=Int64ListCompat))


class FeaturesCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'feature', MESSAGE, map_value=(MESSAGE, FeatureCompat)),)


class ExampleCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'features', MESSAGE, message=FeaturesCompat),)


class ArrayRecordFooterMetadataCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'version', UINT32),
            _f(2, 'num_chunks', UINT64),
            _f(3, 'num_records', UINT64),
            _f(4, 'writer_options', STRING))


class RiegeliFooterMetadataCompat(Message):
  __slots__ = ()
  FIELDS = (_f(1, 'array_record', MESSAGE,
               message=ArrayRecordFooterMetadataCompat),)


MESSAGES = (Point2D, Atom, AtomicGrid, BeamControl, FieldOfView, NDArray,
            TensorShapeProtoCompatDim, TensorShapeProtoCompat,
            TensorProtoCompat, MicroscopeObservation, Trajectory, Transition,
            Drift, LabeledAlignmentTrajectory, ArrayExample, BytesListCompat,
            FloatListCompat, Int64ListCompat, FeatureCompat, FeaturesCompat,
            ExampleCompat, ArrayRecordFooterMetadataCompat,
            RiegeliFooterMetadataCompat)
