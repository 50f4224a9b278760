"""MLIR bytecode, read and written without MLIR: the StableHLO portable
artifacts that `XlaCallModule` carries in a TF SavedModel.

A portable artifact is MLIR bytecode of the VHLO dialect (StableHLO's
versioned twin): the magic `ML\\xefR`, the bytecode version, the producer
(`StableHLO_v<major>.<minor>.<patch>`), then sections:

  * strings: their sizes (with the NUL) in reverse order, then the
    NUL-terminated strings;
  * dialects: each name (with a flag and a nested section where the
    dialect writes a version), the number of op names, then op names
    grouped by dialect, each with its "registered" flag;
  * attribute/type offsets (how long each entry is, and whether it has a
    dialect's own encoding), grouped by dialect, and the entries' bytes;
  * IR: the root op as a block of one op; an op is its name, a mask of the
    parts it has, its location, attribute dictionary, properties,
    results' types, operands, successors, use-list orders and regions (a
    region of an op isolated from above is a nested IR section);
  * resources (none in these files; refused if present) and properties.

Integers are MLIR's prefix varints (the count of trailing zeros of the
first byte gives the extra bytes), signed ones zigzagged. Attributes and
types are held as `Attr` / `Type` values: a dialect, a kind and its
arguments, decoded and encoded by one table of codes (`_ATTR_CODES`,
`_TYPE_CODES`) for the builtin dialect (locations included) and VHLO. An
entry in textual form is kept as its text. `read_module(data)` gives a
`Module`; `write_module(module)` gives bytes that read back equal.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

MAGIC = b'ML\xefR'
# The bytecode version this reader and writer implement (MLIR's current:
# native properties, operand segment sizes among them).
BYTECODE_VERSION = 6
# The VHLO versions (major, minor) whose encodings the tables hold: the
# StableHLO releases up to 1.13, which JAX 0.9 and TF 2.21 write and read.
VHLO_VERSION_MIN = (0, 9)
VHLO_VERSION_MAX = (1, 13)
PRODUCER = 'StableHLO_v1.13.4'

_ALIGNMENT_BYTE = 0xCB
(SECTION_STRING, SECTION_DIALECT, SECTION_ATTR_TYPE, SECTION_ATTR_TYPE_OFFSET,
 SECTION_IR, SECTION_RESOURCE, SECTION_RESOURCE_OFFSET,
 SECTION_DIALECT_VERSIONS, SECTION_PROPERTIES) = range(9)
_NUM_SECTIONS = 9

_HAS_ATTRS, _HAS_RESULTS, _HAS_OPERANDS, _HAS_SUCCESSORS, _HAS_REGIONS, \
    _HAS_USE_LISTS, _HAS_PROPERTIES = (1 << i for i in range(7))


class BytecodeError(ValueError):
  """The bytes are not MLIR bytecode this module reads."""


# --- values of the IR --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Attr:
  """An attribute: `dialect`, `kind` (a name from `_ATTR_CODES`, or
  'text' for an entry kept in its textual form) and its arguments (ints,
  strings, bytes, `Attr`, `Type`, and tuples of these)."""
  dialect: str
  kind: str
  args: tuple = ()


@dataclasses.dataclass(frozen=True)
class Type:
  """A type, as `Attr` is an attribute."""
  dialect: str
  kind: str
  args: tuple = ()


class Value:
  """An SSA value: a block argument (with its location) or an op result."""

  __slots__ = ('type', 'loc')

  def __init__(self, type_: Type, loc: Optional[Attr] = None):
    self.type = type_
    self.loc = loc


@dataclasses.dataclass
class Block:
  args: List[Value] = dataclasses.field(default_factory=list)
  ops: List['Op'] = dataclasses.field(default_factory=list)
  # Use-list orders of the arguments as read: ((index, pair flag,
  # indices), ...), written back unchanged.
  use_lists: tuple = ()


@dataclasses.dataclass
class Region:
  blocks: List[Block] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Op:
  """An operation. `attrs` is a builtin dictionary `Attr` (or None);
  `props`, the op's properties (its inherent attributes) as {name:
  value}, None where an optional one is absent."""
  name: str
  loc: Attr
  attrs: Optional[Attr] = None
  props: Optional[Dict[str, Optional[Attr]]] = None
  operands: List[Value] = dataclasses.field(default_factory=list)
  results: List[Value] = dataclasses.field(default_factory=list)
  regions: List[Region] = dataclasses.field(default_factory=list)
  isolated: bool = False
  registered: bool = True
  use_lists: tuple = ()

  @property
  def attributes(self) -> Dict[str, Attr]:
    """The properties and the attribute dictionary as {name: value}."""
    out = {k: v for k, v in (self.props or {}).items() if v is not None}
    if self.attrs is not None:
      out.update((k.args[0], v) for k, v in self.attrs.args[0])
    return out


@dataclasses.dataclass
class Module:
  """A bytecode file: its version, producer and root op."""
  version: int
  producer: str
  root: Op
  dialect_versions: Dict[str, bytes] = dataclasses.field(default_factory=dict)


def parse_producer(producer: str) -> Tuple[int, int, int]:
  match = re.fullmatch(r'StableHLO_v(\d+)\.(\d+)\.(\d+)', producer)
  if not match:
    raise BytecodeError(
        f'producer {producer!r} is not a StableHLO portable artifact '
        '(StableHLO_v<major>.<minor>.<patch>)')
  return tuple(int(g) for g in match.groups())


def check_vhlo_version(producer: str) -> Tuple[int, int, int]:
  version = parse_producer(producer)
  if not VHLO_VERSION_MIN <= version[:2] <= VHLO_VERSION_MAX:
    lo = '.'.join(map(str, VHLO_VERSION_MIN))
    hi = '.'.join(map(str, VHLO_VERSION_MAX))
    raise BytecodeError(
        f'VHLO version {".".join(map(str, version))} is not one this reader '
        f'knows ({lo} to {hi}.x); see ROADMAP queue 1')
  return version


# --- the table of codes ------------------------------------------------------
#
# Field specs, read and written in order:
#   v varint   s signed varint   B one byte   S string (index)
#   a attribute   t type   b blob   A attributes   T types   V varints
#   Z signed varints   D (attribute, attribute) pairs
#   I an integer of the width of the preceding type (APInt)
#   F a float of the width of the preceding type, as its bits
#   G a float64 as its bits
#   ? an optional attribute (a flag, then the attribute)

_ATTR_CODES = {
    'builtin': {
        0: ('array', 'A'),
        1: ('dictionary', 'D'),
        2: ('string', 'S'),
        3: ('string_typed', 'St'),
        4: ('flat_symbol_ref', 'a'),
        5: ('symbol_ref', 'aA'),
        6: ('type', 't'),
        7: ('unit', ''),
        8: ('integer', 'tI'),
        9: ('float', 'tF'),
        10: ('callsite_loc', 'aa'),
        11: ('file_line_col_loc', 'avv'),
        12: ('fused_loc', 'A'),
        13: ('fused_loc_metadata', 'Aa'),
        14: ('name_loc', 'aa'),
        15: ('unknown_loc', ''),
        17: ('dense_array', 'tvb'),
        18: ('dense_elements', 'tb'),
        21: ('distinct', 'a'),
        22: ('file_line_col_range', 'aV'),
    },
    'vhlo': {
        1: ('array_v1', 'A'),
        2: ('bool_v1', 'v'),
        3: ('comparison_direction_v1', 'v'),
        4: ('comparison_type_v1', 'v'),
        5: ('api_version_v1', 'v'),
        6: ('dict_v1', 'D'),
        7: ('fft_type_v1', 'v'),
        8: ('float_v1', 'tF'),
        9: ('integer_v1', 'tI'),
        10: ('output_operand_alias_v1', 'ZsZ'),
        11: ('precision_v1', 'v'),
        12: ('rng_algorithm_v1', 'v'),
        13: ('rng_distribution_v1', 'v'),
        14: ('string_v1', 'S'),
        15: ('tensor_v1', 'tb'),
        16: ('transpose_v1', 'v'),
        17: ('type_v1', 't'),
        18: ('type_extensions_v1', 'Z'),
        19: ('result_accuracy_mode_v1', 'v'),
        20: ('result_accuracy_v1', 'GGsa'),
    },
}

_TYPE_CODES = {
    'builtin': {
        0: ('integer', 'v'),
        1: ('index', ''),
        2: ('function', 'TT'),
        3: ('bf16', ''),
        4: ('f16', ''),
        5: ('f32', ''),
        6: ('f64', ''),
        12: ('none', ''),
        13: ('ranked_tensor', 'Zt'),
        15: ('tuple', 'T'),
        18: ('unranked_tensor', 't'),
    },
    'vhlo': {
        0: ('bool_v1', ''),
        1: ('complex_v1', 't'),
        2: ('bf16_v1', ''),
        3: ('f16_v1', ''),
        4: ('f32_v1', ''),
        5: ('f64_v1', ''),
        8: ('func_v1', 'TT'),
        9: ('index_v1', ''),
        10: ('i4_v1', ''),
        11: ('i8_v1', ''),
        12: ('i16_v1', ''),
        13: ('i32_v1', ''),
        14: ('i64_v1', ''),
        15: ('ui4_v1', ''),
        16: ('ui8_v1', ''),
        17: ('ui16_v1', ''),
        18: ('ui32_v1', ''),
        19: ('ui64_v1', ''),
        20: ('tensor_v1', 'Zt'),
        21: ('tensor_v1_encoded', 'aZt'),
        22: ('token_v1', ''),
        23: ('tuple_v1', 'T'),
        25: ('unranked_tensor_v1', 't'),
        26: ('witness_v1', ''),
        33: ('none_v1', ''),
    },
}

# The properties of each VHLO op: its inherent attributes, each written as
# an attribute index, in this order (the names sorted, as ODS emits them).
# builtin.module's two are optional (a flag, then the index). Only the ops
# that JAX's exports of the four models (with their gradients) and
# `io/torch_to_stablehlo.py` hold are listed; a file with another op that
# has properties is refused.
_VHLO_PROPERTIES = {
    'broadcast_in_dim_v1': ('broadcast_dimensions',),
    'call_v1': ('callee',),
    'compare_v1': ('compare_type', 'comparison_direction'),
    'concatenate_v1': ('dimension',),
    'constant_v1': ('value',),
    'convolution_v1': (
        'batch_group_count', 'feature_group_count', 'input_batch_dimension',
        'input_feature_dimension', 'input_spatial_dimensions',
        'kernel_input_feature_dimension', 'kernel_output_feature_dimension',
        'kernel_spatial_dimensions', 'lhs_dilation', 'output_batch_dimension',
        'output_feature_dimension', 'output_spatial_dimensions', 'padding',
        'precision_config', 'rhs_dilation', 'window_reversal',
        'window_strides',
    ),
    'dot_general_v2': (
        'accumulation_type', 'allow_imprecise_accumulation',
        'lhs_batching_dimensions', 'lhs_component_count',
        'lhs_contracting_dimensions', 'lhs_precision_type',
        'num_primitive_operations', 'precision_config',
        'rhs_batching_dimensions', 'rhs_component_count',
        'rhs_contracting_dimensions', 'rhs_precision_type',
    ),
    'exponential_v2': ('result_accuracy',),
    'func_v1': (
        'arg_attrs', 'function_type', 'res_attrs', 'sym_name',
        'sym_visibility',
    ),
    'log_plus_one_v2': ('result_accuracy',),
    'logistic_v2': ('result_accuracy',),
    'pad_v1': ('edge_padding_high', 'edge_padding_low', 'interior_padding'),
    'reduce_v1': ('dimensions',),
    'reduce_window_v1': (
        'base_dilations', 'padding', 'window_dilations', 'window_dimensions',
        'window_strides',
    ),
    'reverse_v1': ('dimensions',),
    'rsqrt_v2': ('result_accuracy',),
    'select_and_scatter_v1': ('padding', 'window_dimensions',
                              'window_strides'),
    'slice_v1': ('limit_indices', 'start_indices', 'strides'),
    'tanh_v2': ('result_accuracy',),
    'transpose_v1': ('permutation',),
}
_MODULE_PROPERTIES = ('sym_name', 'sym_visibility')

_ATTR_KINDS = {d: {k: (c, spec) for c, (k, spec) in codes.items()}
               for d, codes in _ATTR_CODES.items()}
_TYPE_KINDS = {d: {k: (c, spec) for c, (k, spec) in codes.items()}
               for d, codes in _TYPE_CODES.items()}

# Bit widths of the types that carry an APInt or APFloat.
_WIDTHS = {
    ('vhlo', 'bool_v1'): 1, ('vhlo', 'i4_v1'): 4, ('vhlo', 'i8_v1'): 8,
    ('vhlo', 'i16_v1'): 16, ('vhlo', 'i32_v1'): 32, ('vhlo', 'i64_v1'): 64,
    ('vhlo', 'ui4_v1'): 4, ('vhlo', 'ui8_v1'): 8, ('vhlo', 'ui16_v1'): 16,
    ('vhlo', 'ui32_v1'): 32, ('vhlo', 'ui64_v1'): 64,
    ('vhlo', 'index_v1'): 64, ('vhlo', 'bf16_v1'): 16,
    ('vhlo', 'f16_v1'): 16, ('vhlo', 'f32_v1'): 32, ('vhlo', 'f64_v1'): 64,
    ('builtin', 'index'): 64, ('builtin', 'bf16'): 16, ('builtin', 'f16'): 16,
    ('builtin', 'f32'): 32, ('builtin', 'f64'): 64,
}


def type_width(t: Type) -> int:
  if t.dialect == 'builtin' and t.kind == 'integer':
    return t.args[0] >> 2
  try:
    return _WIDTHS[(t.dialect, t.kind)]
  except KeyError:
    raise BytecodeError(f'no bit width for type {t.dialect}.{t.kind}'
                        ) from None


# --- varints -----------------------------------------------------------------


class _Reader:
  """A cursor over bytes with MLIR's encodings."""

  __slots__ = ('data', 'pos', 'end', 'base')

  def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None,
               base: int = 0):
    self.data, self.pos = data, pos
    self.end = len(data) if end is None else end
    self.base = base  # offset of data[0] in the file, for alignment

  def empty(self) -> bool:
    return self.pos >= self.end

  def byte(self) -> int:
    if self.pos >= self.end:
      raise BytecodeError('unexpected end of bytecode')
    self.pos += 1
    return self.data[self.pos - 1]

  def bytes(self, n: int) -> bytes:
    if self.pos + n > self.end:
      raise BytecodeError('unexpected end of bytecode')
    self.pos += n
    return self.data[self.pos - n:self.pos]

  def varint(self) -> int:
    first = self.byte()
    if first & 1:
      return first >> 1
    if first == 0:
      return int.from_bytes(self.bytes(8), 'little')
    extra = (first & -first).bit_length() - 1
    rest = self.bytes(extra)
    return int.from_bytes(bytes([first]) + rest, 'little') >> (extra + 1)

  def svarint(self) -> int:
    value = self.varint()
    return (value >> 1) ^ -(value & 1)

  def varint_flag(self) -> Tuple[int, bool]:
    value = self.varint()
    return value >> 1, bool(value & 1)

  def cstring(self) -> str:
    end = self.data.index(b'\0', self.pos, self.end)
    out = self.data[self.pos:end].decode('utf-8')
    self.pos = end + 1
    return out

  def section(self) -> Tuple[int, '_Reader']:
    code = self.byte()
    length = self.varint()
    sid = code & 0x7F
    if sid >= _NUM_SECTIONS:
      raise BytecodeError(f'invalid section id {sid}')
    if code & 0x80:
      alignment = self.varint()
      while (self.base + self.pos) % alignment:
        if self.byte() != _ALIGNMENT_BYTE:
          raise BytecodeError('bad section alignment padding')
    start = self.pos
    self.bytes(length)
    return sid, _Reader(self.data, start, start + length, self.base)


def encode_varint(value: int) -> bytes:
  if value < 0:
    raise BytecodeError(f'negative varint {value}')
  if value >> 7 == 0:
    return bytes([(value << 1) | 1])
    # one byte
  it = value >> 7
  for num_bytes in range(2, 9):
    it >>= 7
    if it == 0:
      encoded = ((value << 1) | 1) << (num_bytes - 1)
      return encoded.to_bytes(num_bytes, 'little')
  return b'\0' + value.to_bytes(8, 'little')


def encode_svarint(value: int) -> bytes:
  return encode_varint(((value << 1) ^ (value >> 63)) & ((1 << 64) - 1))


def _encode_flag(value: int, flag: bool) -> bytes:
  return encode_varint((value << 1) | int(bool(flag)))


def _apint_read(r: _Reader, width: int) -> int:
  if width <= 8:
    return r.byte()
  if width <= 64:
    value = r.svarint()
    return value & ((1 << width) - 1)
  words = [r.svarint() & ((1 << 64) - 1) for _ in range(r.varint())]
  return sum(w << (64 * i) for i, w in enumerate(words))


def _apint_write(value: int, width: int) -> bytes:
  value &= (1 << width) - 1
  if width <= 8:
    return bytes([value])
  if width <= 64:
    signed = value - (1 << width) if value >> (width - 1) else value
    return encode_svarint(signed)
  words = [(value >> (64 * i)) & ((1 << 64) - 1)
           for i in range((width + 63) // 64)]
  return encode_varint(len(words)) + b''.join(
      encode_svarint(w - (1 << 64) if w >> 63 else w) for w in words)


# --- reading -----------------------------------------------------------------


class _Tables:
  """The file's strings, dialects, op names, attributes and types, with
  attributes and types decoded on first use."""

  def __init__(self):
    self.strings: List[str] = []
    self.dialects: List[str] = []
    self.dialect_versions: Dict[str, bytes] = {}
    self.op_names: List[Tuple[str, bool]] = []
    self.attr_entries: list = []
    self.type_entries: list = []
    self.attrs: Dict[int, Attr] = {}
    self.types: Dict[int, Type] = {}
    self.properties: List[bytes] = []

  def string(self, index: int) -> str:
    try:
      return self.strings[index]
    except IndexError:
      raise BytecodeError(f'string index {index} out of range') from None

  def attr(self, index: int) -> Attr:
    if index not in self.attrs:
      if index >= len(self.attr_entries):
        raise BytecodeError(f'attribute index {index} out of range')
      self.attrs[index] = self._decode(self.attr_entries[index], False)
    return self.attrs[index]

  def type(self, index: int) -> Type:
    if index not in self.types:
      if index >= len(self.type_entries):
        raise BytecodeError(f'type index {index} out of range')
      self.types[index] = self._decode(self.type_entries[index], True)
    return self.types[index]

  def _decode(self, entry, is_type: bool):
    dialect, custom, data = entry
    cls = Type if is_type else Attr
    if not custom:
      if not data.endswith(b'\0'):
        raise BytecodeError('textual attribute without its NUL')
      return cls(dialect, 'text', (data[:-1].decode('utf-8'),))
    codes = (_TYPE_CODES if is_type else _ATTR_CODES).get(dialect)
    what = 'type' if is_type else 'attribute'
    if codes is None:
      raise BytecodeError(f'no bytecode encoding for {what}s of dialect '
                          f'{dialect!r}')
    r = _Reader(data)
    code = r.varint()
    if code not in codes:
      raise BytecodeError(f'{dialect} {what} code {code} is not one this '
                          'reader knows; see ROADMAP queue 1')
    kind, spec = codes[code]
    args = self._read_fields(r, spec)
    if not r.empty():
      raise BytecodeError(f'{dialect}.{kind}: {r.end - r.pos} bytes left over')
    return cls(dialect, kind, args)

  def _read_fields(self, r: _Reader, spec: str) -> tuple:
    out = []
    for f in spec:
      if f == 'v':
        out.append(r.varint())
      elif f == 's':
        out.append(r.svarint())
      elif f == 'B':
        out.append(r.byte())
      elif f == 'S':
        out.append(self.string(r.varint()))
      elif f == 'a':
        out.append(self.attr(r.varint()))
      elif f == 't':
        out.append(self.type(r.varint()))
      elif f == 'b':
        out.append(r.bytes(r.varint()))
      elif f == 'A':
        out.append(tuple(self.attr(r.varint()) for _ in range(r.varint())))
      elif f == 'T':
        out.append(tuple(self.type(r.varint()) for _ in range(r.varint())))
      elif f == 'V':
        out.append(tuple(r.varint() for _ in range(r.varint())))
      elif f == 'Z':
        out.append(tuple(r.svarint() for _ in range(r.varint())))
      elif f == 'D':
        out.append(tuple((self.attr(r.varint()), self.attr(r.varint()))
                         for _ in range(r.varint())))
      elif f in 'IF':
        out.append(_apint_read(r, type_width(out[-1])))
      elif f == 'G':
        out.append(_apint_read(r, 64))
      elif f == '?':
        index, present = r.varint_flag()
        out.append(self.attr(index) if present else None)
      else:
        raise AssertionError(f)
    return tuple(out)


def _dialect_grouping(r: _Reader, tables: _Tables, callback) -> None:
  dialect = r.varint()
  if dialect >= len(tables.dialects):
    raise BytecodeError(f'dialect index {dialect} out of range')
  for _ in range(r.varint()):
    callback(tables.dialects[dialect])


def _read_strings(r: _Reader, tables: _Tables) -> None:
  n = r.varint()
  sizes = [r.varint() for _ in range(n)][::-1]
  end = r.end
  strings = []
  for size in reversed(sizes):
    strings.append(r.data[end - size:end - 1].decode('utf-8'))
    end -= size
  tables.strings = strings[::-1]
  if end < r.pos:
    raise BytecodeError('string section sizes overrun its data')


def _read_dialects(r: _Reader, tables: _Tables) -> None:
  for _ in range(r.varint()):
    index, has_version = r.varint_flag()
    name = tables.string(index)
    tables.dialects.append(name)
    if has_version:
      sid, sub = r.section()
      if sid != SECTION_DIALECT_VERSIONS:
        raise BytecodeError('expected a dialect version section')
      tables.dialect_versions[name] = sub.data[sub.pos:sub.end]
  r.varint()  # the number of op names, a reservation hint

  def op_name(dialect):
    index, registered = r.varint_flag()
    tables.op_names.append((f'{dialect}.{tables.string(index)}', registered))

  while not r.empty():
    _dialect_grouping(r, tables, op_name)


def _read_attr_types(offsets: _Reader, data: _Reader, tables: _Tables) -> None:
  num_attrs, num_types = offsets.varint(), offsets.varint()
  cursor = data.pos
  for total, out in ((num_attrs, tables.attr_entries),
                     (num_types, tables.type_entries)):
    def entry(dialect, out=out):
      nonlocal cursor
      size, custom = offsets.varint_flag()
      if cursor + size > data.end:
        raise BytecodeError('attribute/type entry past its section')
      out.append((dialect, custom, data.data[cursor:cursor + size]))
      cursor += size
    while len(out) < total:
      _dialect_grouping(offsets, tables, entry)


def _read_properties(r: _Reader, tables: _Tables) -> None:
  if r.empty():
    return
  count = r.varint()
  for _ in range(count):
    size = r.varint()
    tables.properties.append(r.bytes(size))


class _IRReader:
  """Reads the IR section: a value scope for each region isolated from
  above, values numbered as the writer numbered them."""

  def __init__(self, tables: _Tables):
    self.t = tables
    self.scopes: List[List[Optional[Value]]] = []
    self.next_ids: List[List[int]] = []

  def _define(self, value: Value) -> None:
    ids = self.next_ids[-1]
    scope = self.scopes[-1]
    scope[ids[-1]] = value
    ids[-1] += 1

  def _operand(self, r: _Reader) -> Value:
    index = r.varint()
    scope = self.scopes[-1]
    if index >= len(scope) or scope[index] is None:
      # Forward references (graph regions) do not occur in these files.
      raise BytecodeError(f'operand {index} used before it is defined')
    return scope[index]

  def _use_lists(self, r: _Reader, count: int) -> tuple:
    out = []
    num = r.varint() if count > 1 else 1
    for _ in range(num):
      index = r.varint() if count > 1 else 0
      n, pairs = r.varint_flag()
      out.append((index, pairs, tuple(r.varint() for _ in range(n))))
    return tuple(out)

  def _block_header(self, r: _Reader, block: Block) -> int:
    num_ops, has_args = r.varint_flag()
    if has_args:
      for _ in range(r.varint()):
        index, has_loc = r.varint_flag()
        loc = self.t.attr(r.varint()) if has_loc else Attr(
            'builtin', 'unknown_loc')
        value = Value(self.t.type(index), loc)
        block.args.append(value)
        self._define(value)
      if r.byte():
        block.use_lists = self._use_lists(r, len(block.args))
    return num_ops

  def _region(self, r: _Reader) -> Region:
    region = Region()
    num_blocks = r.varint()
    if not num_blocks:
      return region
    num_values = r.varint()
    scope = self.scopes[-1]
    self.next_ids[-1].append(len(scope))
    scope.extend([None] * num_values)
    region.blocks = [Block() for _ in range(num_blocks)]
    for block in region.blocks:
      for _ in range(self._block_header(r, block)):
        block.ops.append(self._op(r, region))
    del scope[len(scope) - num_values:]
    self.next_ids[-1].pop()
    return region

  def _props(self, name: str, index: int) -> Dict[str, Optional[Attr]]:
    try:
      r = _Reader(self.t.properties[index])
    except IndexError:
      raise BytecodeError(f'properties index {index} out of range') from None
    names, spec = _property_layout(name)
    values = self.t._read_fields(r, spec)
    if not r.empty():
      raise BytecodeError(f'{name}: properties longer than its layout')
    return dict(zip(names, values))

  def _op(self, r: _Reader, region: Optional[Region]) -> Op:
    index = r.varint()
    try:
      name, registered = self.t.op_names[index]
    except IndexError:
      raise BytecodeError(f'op name index {index} out of range') from None
    mask = r.byte()
    op = Op(name=name, loc=self.t.attr(r.varint()), registered=registered)
    if mask & _HAS_ATTRS:
      op.attrs = self.t.attr(r.varint())
    if mask & _HAS_PROPERTIES:
      op.props = self._props(name, r.varint())
    if mask & _HAS_RESULTS:
      op.results = [Value(self.t.type(r.varint()))
                    for _ in range(r.varint())]
    if mask & _HAS_OPERANDS:
      op.operands = [self._operand(r) for _ in range(r.varint())]
    if mask & _HAS_SUCCESSORS:
      raise BytecodeError(f'{name}: successors (unstructured control flow) '
                          'do not occur in StableHLO')
    if mask & _HAS_USE_LISTS:
      op.use_lists = self._use_lists(r, len(op.results))
    for value in op.results:
      self._define(value)
    if mask & _HAS_REGIONS:
      num_regions, op.isolated = r.varint_flag()
      if op.isolated:
        sid, sub = r.section()
        if sid != SECTION_IR:
          raise BytecodeError('expected an IR section for an isolated region')
        self.scopes.append([])
        self.next_ids.append([])
        op.regions = [self._region(sub) for _ in range(num_regions)]
        self.scopes.pop()
        self.next_ids.pop()
      else:
        op.regions = [self._region(r) for _ in range(num_regions)]
    return op

  def read(self, r: _Reader) -> Op:
    self.scopes.append([])
    self.next_ids.append([0])
    num_ops, has_args = r.varint_flag()
    if num_ops != 1 or has_args:
      raise BytecodeError('the IR section does not hold one root op')
    return self._op(r, None)


def read_module(data: bytes) -> Module:
  """Parses a bytecode file; raises BytecodeError naming what it does not
  know (a bytecode version, a VHLO version, an attribute or type code, the
  properties of an op)."""
  data = bytes(data)
  if not data.startswith(MAGIC):
    raise BytecodeError('not MLIR bytecode (no ML\\xefR magic)')
  r = _Reader(data, len(MAGIC))
  version = r.varint()
  if version != BYTECODE_VERSION:
    raise BytecodeError(
        f'MLIR bytecode version {version} is not the one this reader knows '
        f'({BYTECODE_VERSION}); see ROADMAP queue 1')
  producer = r.cstring()
  check_vhlo_version(producer)
  sections: Dict[int, _Reader] = {}
  while not r.empty():
    sid, sub = r.section()
    if sid in sections:
      raise BytecodeError(f'section {sid} appears twice')
    sections[sid] = sub
  for required in (SECTION_STRING, SECTION_DIALECT, SECTION_ATTR_TYPE,
                   SECTION_ATTR_TYPE_OFFSET, SECTION_IR):
    if required not in sections:
      raise BytecodeError(f'section {required} is missing')
  # The resource offsets open with the number of resource groups: none in
  # these files.
  offsets = sections.get(SECTION_RESOURCE_OFFSET)
  if offsets is not None and not offsets.empty() and offsets.varint():
    raise BytecodeError('dialect resources (dense_resource blobs) are not '
                        'read here; see ROADMAP queue 1')
  tables = _Tables()
  _read_strings(sections[SECTION_STRING], tables)
  _read_dialects(sections[SECTION_DIALECT], tables)
  _read_attr_types(sections[SECTION_ATTR_TYPE_OFFSET],
                   sections[SECTION_ATTR_TYPE], tables)
  if SECTION_PROPERTIES in sections:
    _read_properties(sections[SECTION_PROPERTIES], tables)
  root = _IRReader(tables).read(sections[SECTION_IR])
  return Module(version, producer, root, dict(tables.dialect_versions))


# --- writing -----------------------------------------------------------------


def _walk_ops(op: Op):
  yield op
  for region in op.regions:
    for block in region.blocks:
      for inner in block.ops:
        yield from _walk_ops(inner)


class _Numbering:
  """Indices of strings, dialects, op names, attributes and types, in
  first-use order, with attributes and types grouped by dialect."""

  def __init__(self, module: Module):
    self.strings: Dict[str, int] = {}
    self.dialects: Dict[str, int] = {}
    self.op_names: Dict[Tuple[str, bool], int] = {}
    self._attrs: Dict[Attr, None] = {}
    self._types: Dict[Type, None] = {}
    for d in module.dialect_versions:
      self.dialect(d)
    ops = list(_walk_ops(module.root))
    for op in ops:
      dialect = op.name.split('.', 1)[0]
      self.dialect(dialect)
      self.op_names.setdefault((op.name, op.registered), len(self.op_names))
    for op in ops:
      self.add(op.loc)
      if op.attrs is not None:
        self.add(op.attrs)
      for p in (op.props or {}).values():
        if p is not None:
          self.add(p)
      for v in op.results:
        self.add(v.type)
      for region in op.regions:
        for block in region.blocks:
          for v in block.args:
            self.add(v.type)
            if not _is_unknown(v.loc):
              self.add(v.loc)
    # Group by dialect (the offset table is written in dialect groups).
    self.attrs = self._grouped(self._attrs)
    self.types = self._grouped(self._types)
    for entry in list(self.attrs) + list(self.types):
      self.dialect(entry.dialect)
    for name, _ in self.op_names:
      self.string(name.split('.', 1)[1])
    for entry in list(self.attrs) + list(self.types):
      self._strings_of(entry)

  def _grouped(self, entries) -> Dict:
    order = list(entries)
    dialects = list(dict.fromkeys(e.dialect for e in order))
    out = {}
    for d in dialects:
      for e in order:
        if e.dialect == d:
          out[e] = len(out)
    return out

  def dialect(self, name: str) -> int:
    if name not in self.dialects:
      self.dialects[name] = len(self.dialects)
      self.string(name)
    return self.dialects[name]

  def string(self, s: str) -> int:
    if s not in self.strings:
      self.strings[s] = len(self.strings)
    return self.strings[s]

  def _spec(self, entry) -> str:
    if entry.kind == 'text':
      return ''
    kinds = (_TYPE_KINDS if isinstance(entry, Type) else _ATTR_KINDS)
    try:
      return kinds[entry.dialect][entry.kind][1]
    except KeyError:
      raise BytecodeError(
          f'no encoding for {entry.dialect}.{entry.kind}') from None

  def add(self, entry) -> None:
    table = self._types if isinstance(entry, Type) else self._attrs
    if entry in table:
      return
    for f, arg in zip(self._spec(entry), entry.args):
      if f in 'at?' and arg is not None:
        self.add(arg)
      elif f in 'AT':
        for a in arg:
          self.add(a)
      elif f == 'D':
        for k, v in arg:
          self.add(k)
          self.add(v)
    table[entry] = None

  def _strings_of(self, entry) -> None:
    for f, arg in zip(self._spec(entry), entry.args):
      if f == 'S':
        self.string(arg)

  def attr(self, a: Attr) -> int:
    return self.attrs[a]

  def type(self, t: Type) -> int:
    return self.types[t]


def _property_layout(name: str) -> Tuple[Tuple[str, ...], str]:
  """(names, field spec) of an op's properties."""
  if name == 'builtin.module':
    return _MODULE_PROPERTIES, '??'
  dialect, _, short = name.partition('.')
  if dialect == 'vhlo' and short in _VHLO_PROPERTIES:
    names = _VHLO_PROPERTIES[short]
    return names, 'a' * len(names)
  raise BytecodeError(f'the properties of {name} are not known here')


def _is_unknown(loc) -> bool:
  return loc is None or (loc.dialect == 'builtin' and loc.kind == 'unknown_loc')


def _encode_entry(entry, n: _Numbering) -> Tuple[bytes, bool]:
  if entry.kind == 'text':
    return entry.args[0].encode('utf-8') + b'\0', False
  kinds = _TYPE_KINDS if isinstance(entry, Type) else _ATTR_KINDS
  code, spec = kinds[entry.dialect][entry.kind]
  out = [encode_varint(code)]
  prev = None
  for f, arg in zip(spec, entry.args):
    if f == 'v':
      out.append(encode_varint(arg))
    elif f == 's':
      out.append(encode_svarint(arg))
    elif f == 'B':
      out.append(bytes([arg]))
    elif f == 'S':
      out.append(encode_varint(n.string(arg)))
    elif f == 'a':
      out.append(encode_varint(n.attr(arg)))
    elif f == 't':
      out.append(encode_varint(n.type(arg)))
    elif f == 'b':
      out.append(encode_varint(len(arg)) + bytes(arg))
    elif f == 'A':
      out.append(encode_varint(len(arg)))
      out.extend(encode_varint(n.attr(a)) for a in arg)
    elif f == 'T':
      out.append(encode_varint(len(arg)))
      out.extend(encode_varint(n.type(a)) for a in arg)
    elif f == 'V':
      out.append(encode_varint(len(arg)))
      out.extend(encode_varint(a) for a in arg)
    elif f == 'Z':
      out.append(encode_varint(len(arg)))
      out.extend(encode_svarint(a) for a in arg)
    elif f == 'D':
      out.append(encode_varint(len(arg)))
      for k, v in arg:
        out.append(encode_varint(n.attr(k)) + encode_varint(n.attr(v)))
    elif f in 'IF':
      out.append(_apint_write(arg, type_width(prev)))
    elif f == 'G':
      out.append(_apint_write(arg, 64))
    elif f == '?':
      out.append(_encode_flag(0, False) if arg is None
                 else _encode_flag(n.attr(arg), True))
    prev = arg
  return b''.join(out), True


def _dialect_groups(entries, dialect_of, n: _Numbering):
  """(dialect index, [entries]) runs of consecutive entries of one
  dialect."""
  groups = []
  for e in entries:
    d = n.dialects[dialect_of(e)]
    if groups and groups[-1][0] == d:
      groups[-1][1].append(e)
    else:
      groups.append((d, [e]))
  return groups


class _IRWriter:

  def __init__(self, n: _Numbering):
    self.n = n
    self.properties: List[bytes] = []
    self._props_index: Dict[bytes, int] = {}
    self.value_ids: List[Dict[int, int]] = []

  def _number_scope(self, op: Op) -> Dict[int, int]:
    """Value ids inside `op`'s isolated regions, as MLIR's IRNumbering
    gives them: a region's own values in order, nested regions' after
    their parent's."""
    ids: Dict[int, int] = {}
    counts: Dict[int, int] = {}
    work = [(region, 0) for region in reversed(op.regions)]
    while work:
      region, next_id = work.pop()
      first = next_id
      for block in region.blocks:
        for v in block.args:
          ids[id(v)] = next_id
          next_id += 1
        for inner in block.ops:
          for v in inner.results:
            ids[id(v)] = next_id
            next_id += 1
      counts[id(region)] = next_id - first
      for block in region.blocks:
        for inner in block.ops:
          if inner.regions and not inner.isolated:
            work.extend((r, next_id) for r in reversed(inner.regions))
    self._counts.update(counts)
    return ids

  def _props(self, op: Op) -> int:
    names, spec = _property_layout(op.name)
    if set(op.props) != set(names):
      raise BytecodeError(f'{op.name} takes the properties {names}, got '
                          f'{tuple(op.props)}')
    body = []
    for name, f in zip(names, spec):
      p = op.props[name]
      if f == 'a':
        body.append(encode_varint(self.n.attr(p)))
      else:
        body.append(_encode_flag(0, False) if p is None
                    else _encode_flag(self.n.attr(p), True))
    body = b''.join(body)
    data = encode_varint(len(body)) + body
    if data not in self._props_index:
      self._props_index[data] = len(self.properties)
      self.properties.append(data)
    return self._props_index[data]

  def _use_lists(self, use_lists: tuple, count: int) -> bytes:
    out = []
    if count > 1:
      out.append(encode_varint(len(use_lists)))
    for index, pairs, indices in use_lists:
      if count > 1:
        out.append(encode_varint(index))
      out.append(_encode_flag(len(indices), pairs))
      out.extend(encode_varint(i) for i in indices)
    return b''.join(out)

  def op(self, op: Op) -> bytes:
    n = self.n
    out = [encode_varint(n.op_names[(op.name, op.registered)]), b'\0',
           encode_varint(n.attr(op.loc))]
    mask = 0
    if op.attrs is not None:
      mask |= _HAS_ATTRS
      out.append(encode_varint(n.attr(op.attrs)))
    if op.props is not None:
      mask |= _HAS_PROPERTIES
      out.append(encode_varint(self._props(op)))
    if op.results:
      mask |= _HAS_RESULTS
      out.append(encode_varint(len(op.results)))
      out.extend(encode_varint(n.type(v.type)) for v in op.results)
    if op.operands:
      mask |= _HAS_OPERANDS
      out.append(encode_varint(len(op.operands)))
      ids = self.value_ids[-1]
      for v in op.operands:
        if id(v) not in ids:
          raise BytecodeError(f'{op.name}: an operand is not defined in '
                              'its scope')
        out.append(encode_varint(ids[id(v)]))
    if op.use_lists:
      mask |= _HAS_USE_LISTS
      out.append(self._use_lists(op.use_lists, len(op.results)))
    if op.regions:
      mask |= _HAS_REGIONS
      out.append(_encode_flag(len(op.regions), op.isolated))
      if op.isolated:
        self.value_ids.append(self._number_scope(op))
        body = b''.join(self.region(r) for r in op.regions)
        self.value_ids.pop()
        out.append(bytes([SECTION_IR]) + encode_varint(len(body)) + body)
      else:
        out.extend(self.region(r) for r in op.regions)
    out[1] = bytes([mask])
    return b''.join(out)

  def region(self, region: Region) -> bytes:
    if not region.blocks:
      return encode_varint(0)
    out = [encode_varint(len(region.blocks)),
           encode_varint(self._counts[id(region)])]
    for block in region.blocks:
      out.append(_encode_flag(len(block.ops), bool(block.args)))
      if block.args:
        out.append(encode_varint(len(block.args)))
        for v in block.args:
          known = not _is_unknown(v.loc)
          out.append(_encode_flag(self.n.type(v.type), known))
          if known:
            out.append(encode_varint(self.n.attr(v.loc)))
        if block.use_lists:
          out.append(b'\x01' + self._use_lists(block.use_lists,
                                               len(block.args)))
        else:
          out.append(b'\0')
      out.extend(self.op(inner) for inner in block.ops)
    return b''.join(out)

  def root(self, op: Op) -> bytes:
    self._counts: Dict[int, int] = {}
    if op.regions and not op.isolated:
      raise BytecodeError('the root op must be isolated from above')
    self.value_ids.append({})
    return _encode_flag(1, False) + self.op(op)


def write_module(module: Module) -> bytes:
  """The bytecode of `module`: sections in the order MLIR's writer puts
  them (dialects, attribute/type offsets and data, IR, resources,
  strings, properties)."""
  if module.version != BYTECODE_VERSION:
    raise BytecodeError(f'cannot write bytecode version {module.version}')
  check_vhlo_version(module.producer)
  n = _Numbering(module)
  ir = _IRWriter(n)
  ir_body = ir.root(module.root)

  attr_blobs, type_blobs = [], []
  for entries, blobs in ((n.attrs, attr_blobs), (n.types, type_blobs)):
    for e in entries:
      blobs.append(_encode_entry(e, n))

  # Dialects and op names.
  dialect = [encode_varint(len(n.dialects))]
  for name in n.dialects:
    version = module.dialect_versions.get(name)
    dialect.append(_encode_flag(n.string(name), version is not None))
    if version is not None:
      dialect.append(bytes([SECTION_DIALECT_VERSIONS])
                     + encode_varint(len(version)) + version)
  dialect.append(encode_varint(len(n.op_names)))
  # In runs of one dialect, in the order of their numbers: the reader
  # numbers them as it reads them.
  names = sorted(n.op_names, key=n.op_names.get)
  for d, group in _dialect_groups(names, lambda e: e[0].split('.', 1)[0], n):
    dialect.append(encode_varint(d) + encode_varint(len(group)))
    for name, registered in group:
      dialect.append(_encode_flag(n.string(name.split('.', 1)[1]),
                                  registered))

  offsets = [encode_varint(len(attr_blobs)), encode_varint(len(type_blobs))]
  data = []
  for entries, blobs in ((list(n.attrs), attr_blobs),
                         (list(n.types), type_blobs)):
    pairs = list(zip(entries, blobs))
    for d, group in _dialect_groups(pairs, lambda p: p[0].dialect, n):
      offsets.append(encode_varint(d) + encode_varint(len(group)))
      for _, (blob, custom) in group:
        offsets.append(_encode_flag(len(blob), custom))
        data.append(blob)

  strings = sorted(n.strings, key=n.strings.get)
  string_body = [encode_varint(len(strings))]
  string_body += [encode_varint(len(s.encode('utf-8')) + 1)
                  for s in reversed(strings)]
  string_body += [s.encode('utf-8') + b'\0' for s in strings]

  props = [encode_varint(len(ir.properties))] + ir.properties

  def section(sid: int, body) -> bytes:
    body = b''.join(body)
    return bytes([sid]) + encode_varint(len(body)) + body

  return b''.join([
      MAGIC, encode_varint(module.version), module.producer.encode(), b'\0',
      section(SECTION_DIALECT, dialect),
      section(SECTION_ATTR_TYPE_OFFSET, offsets),
      section(SECTION_ATTR_TYPE, data),
      section(SECTION_IR, [ir_body]),
      section(SECTION_RESOURCE_OFFSET, [encode_varint(0)]),
      section(SECTION_RESOURCE, []),
      section(SECTION_STRING, string_body),
      section(SECTION_PROPERTIES, props)])


# --- comparing and printing --------------------------------------------------


def canonical(module: Module) -> tuple:
  """A nested tuple of everything the module holds, with values named by
  their order of definition: two modules that read back equal have equal
  canonical forms."""
  names: Dict[int, int] = {}

  def name(v: Value) -> int:
    return names.setdefault(id(v), len(names))

  def op_form(op: Op) -> tuple:
    for v in op.results:
      name(v)
    regions = []
    for region in op.regions:
      blocks = []
      for block in region.blocks:
        args = tuple((name(v), v.type, v.loc if not _is_unknown(v.loc)
                      else None) for v in block.args)
        blocks.append((args, block.use_lists,
                       tuple(op_form(o) for o in block.ops)))
      regions.append(tuple(blocks))
    props = None if op.props is None else tuple(sorted(op.props.items()))
    return (op.name, op.registered, op.loc, op.attrs, props,
            tuple(name(v) for v in op.operands),
            tuple(v.type for v in op.results), op.use_lists, op.isolated,
            tuple(regions))

  return (module.version, module.producer,
          tuple(sorted(module.dialect_versions.items())),
          op_form(module.root))


def tensor_type_of(t: Type) -> Tuple[Tuple[int, ...], Type]:
  """(shape, element type) of a ranked VHLO tensor type."""
  if t.dialect == 'vhlo' and t.kind == 'tensor_v1':
    return tuple(t.args[0]), t.args[1]
  if t.dialect == 'vhlo' and t.kind == 'tensor_v1_encoded':
    return tuple(t.args[1]), t.args[2]
  raise BytecodeError(f'{t.dialect}.{t.kind} is not a ranked tensor type')
