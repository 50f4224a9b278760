"""TensorFlow's V2 tensor bundle (a SavedModel's `variables/`), read and
written without TensorFlow.

A bundle at `prefix` is `prefix.index` and one data shard
`prefix.data-00000-of-00001`. The index is a LevelDB-style table:

  * data blocks of entries, each `varint32 shared, varint32 non_shared,
    varint32 value_length`, the key's unshared tail and the value (keys
    prefix-compressed against the previous key, reset at every restart
    point: every 16th entry), then the restart offsets (uint32 each) and
    their count;
  * after each block a trailer: the compression byte (0, none) and the
    masked CRC32C of the block and that byte;
  * a metaindex block (empty) and an index block whose entries map the
    shortest key past each data block to its handle (varint64 offset,
    varint64 size);
  * the footer: the two handles, zero-padded to 40 bytes, and the magic
    number 0xdb4775248b80fb57 (little-endian).

Key "" holds the `BundleHeaderProto`; every other key a tensor's
`BundleEntryProto` (dtype, shape, offset and size in the shard, masked
CRC32C of its bytes). Numeric tensors are their row-major little-endian
bytes; a string tensor is the varint64 length of each element, the
masked CRC32C of those lengths (as uint32s), then the elements' bytes.
Masked CRC32C is TFRecord's (`io/records.mask`), over CRC32C from the
port's native library (`io/native.py`).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np

from putting_dune_torch.io import native
from putting_dune_torch.io import records
from putting_dune_torch.io import tensorproto
from putting_dune_torch.proto import tf_wire
from putting_dune_torch.proto import wire

TABLE_MAGIC = 0xdb4775248b80fb57
_RESTART_INTERVAL = 16
_BLOCK_SIZE = 262144
_FOOTER_SIZE = 48

# A numeric tensor, a scalar string tensor (bytes) or a 1-D one (a list).
BundleValue = Union[np.ndarray, bytes, List[bytes]]


class BundleError(ValueError):
  """The files are not a tensor bundle this module reads."""


def _crc(data: bytes) -> int:
  return native.crc32c(data)


mask = records.mask  # TFRecord's masked CRC: the bundle's too


# The table's varints are protobuf's (LEB128).
_varint, _put_varint = wire.read_varint, wire.encode_varint


def data_path(prefix: str) -> str:
  return f'{prefix}.data-00000-of-00001'


# --- the table ---------------------------------------------------------------


def _read_block(data: bytes, offset: int, size: int) -> List[Tuple[bytes,
                                                                   bytes]]:
  if offset + size + 5 > len(data):
    raise BundleError('a block handle points past the index file')
  block = data[offset:offset + size]
  kind = data[offset + size]
  (stored,) = struct.unpack_from('<I', data, offset + size + 1)
  if kind != 0:
    raise BundleError(f'compressed index blocks (type {kind}) are not read')
  if stored != mask(_crc(block + bytes([kind]))):
    raise BundleError('index block checksum mismatch')
  (num_restarts,) = struct.unpack_from('<I', block, size - 4)
  end = size - 4 - 4 * num_restarts
  entries, key, pos = [], b'', 0
  while pos < end:
    shared, pos = _varint(block, pos)
    unshared, pos = _varint(block, pos)
    length, pos = _varint(block, pos)
    key = key[:shared] + block[pos:pos + unshared]
    pos += unshared
    entries.append((key, block[pos:pos + length]))
    pos += length
  return entries


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
  """The (key, value) entries of a table file, in key order."""
  with open(path, 'rb') as f:
    data = f.read()
  if len(data) < _FOOTER_SIZE:
    raise BundleError(f'{path}: too short for a table')
  (magic,) = struct.unpack_from('<Q', data, len(data) - 8)
  if magic != TABLE_MAGIC:
    raise BundleError(f'{path}: bad table magic {magic:#x}')
  footer = data[len(data) - _FOOTER_SIZE:]
  _, pos = _varint(footer, 0)
  _, pos = _varint(footer, pos)
  index_offset, pos = _varint(footer, pos)
  index_size, pos = _varint(footer, pos)
  entries = []
  for _, handle in _read_block(data, index_offset, index_size):
    offset, p = _varint(handle, 0)
    size, _ = _varint(handle, p)
    entries.extend(_read_block(data, offset, size))
  return entries


def _block(entries: List[Tuple[bytes, bytes]]) -> bytes:
  out, restarts, prev = bytearray(), [], b''
  for i, (key, value) in enumerate(entries):
    if i % _RESTART_INTERVAL == 0:
      restarts.append(len(out))
      shared = 0
    else:
      shared = 0
      limit = min(len(prev), len(key))
      while shared < limit and prev[shared] == key[shared]:
        shared += 1
    out += _put_varint(shared) + _put_varint(len(key) - shared)
    out += _put_varint(len(value)) + key[shared:] + value
    prev = key
  if not restarts:
    restarts = [0]
  out += b''.join(struct.pack('<I', r) for r in restarts)
  out += struct.pack('<I', len(restarts))
  return bytes(out)


def _short_successor(key: bytes) -> bytes:
  """LevelDB's FindShortSuccessor: the first byte that can be raised,
  raised, and the rest cut."""
  for i, byte in enumerate(key):
    if byte != 0xFF:
      return key[:i] + bytes([byte + 1])
  return key


def _short_separator(start: bytes, limit: bytes) -> bytes:
  """LevelDB's FindShortestSeparator between two block's keys."""
  n = min(len(start), len(limit))
  i = 0
  while i < n and start[i] == limit[i]:
    i += 1
  if i < n and start[i] < 0xFF and start[i] + 1 < limit[i]:
    return start[:i] + bytes([start[i] + 1])
  return start


def write_table(path: str, entries: List[Tuple[bytes, bytes]]) -> None:
  """Writes sorted (key, value) entries as a table file."""
  keys = [k for k, _ in entries]
  if keys != sorted(keys) or len(set(keys)) != len(keys):
    raise BundleError('table keys must be unique and sorted')
  out = bytearray()
  index = []

  def emit(block_bytes: bytes) -> Tuple[int, int]:
    offset = len(out)
    trailer = bytes([0]) + struct.pack('<I', mask(_crc(block_bytes + b'\0')))
    out.extend(block_bytes + trailer)
    return offset, len(block_bytes)

  blocks, current, size = [], [], 0
  for key, value in entries:
    current.append((key, value))
    size += len(key) + len(value) + 8
    if size >= _BLOCK_SIZE:
      blocks.append(current)
      current, size = [], 0
  if current or not blocks:
    blocks.append(current)
  for i, block in enumerate(blocks):
    offset, length = emit(_block(block))
    last = block[-1][0] if block else b''
    if i + 1 < len(blocks):
      sep = _short_separator(last, blocks[i + 1][0][0])
    else:
      sep = _short_successor(last)
    index.append((sep, _put_varint(offset) + _put_varint(length)))
  meta = emit(_block([]))
  idx = emit(_block(index))
  footer = (_put_varint(meta[0]) + _put_varint(meta[1])
            + _put_varint(idx[0]) + _put_varint(idx[1]))
  footer = footer.ljust(40, b'\0') + struct.pack('<Q', TABLE_MAGIC)
  out.extend(footer)
  with open(path, 'wb') as f:
    f.write(bytes(out))


# --- the bundle --------------------------------------------------------------


def _string_tensor_bytes(values: List[bytes]) -> Tuple[bytes, int]:
  """The shard bytes of a string tensor and their CRC32C, which (as TF
  computes it) runs over the lengths as uint32s, not their varints."""
  lengths = b''.join(_put_varint(len(v)) for v in values)
  wide = b''.join(struct.pack('<I', len(v)) for v in values)
  check = struct.pack('<I', mask(_crc(wide)))
  body = b''.join(values)
  return lengths + check + body, _crc(wide + check + body)


def _read_string_tensor(data: bytes, count: int, crc: int) -> List[bytes]:
  pos, lengths = 0, []
  for _ in range(count):
    n, pos = _varint(data, pos)
    lengths.append(n)
  wide = b''.join(struct.pack('<I', n) for n in lengths)
  check = data[pos:pos + 4]
  if len(check) != 4 or struct.unpack('<I', check)[0] != mask(_crc(wide)):
    raise BundleError('string tensor lengths checksum mismatch')
  pos += 4
  out = []
  for n in lengths:
    out.append(data[pos:pos + n])
    pos += n
  if mask(_crc(wide + check + b''.join(out))) != crc:
    raise BundleError('string tensor data checksum mismatch')
  return out


def read_bundle(prefix: str) -> Tuple[tf_wire.BundleHeaderProto,
                                      Dict[str, BundleValue]]:
  """(header, {name: value}) of the bundle at `prefix`: numeric tensors as
  arrays, a scalar string tensor as bytes, a 1-D one as a list."""
  entries = read_table(f'{prefix}.index')
  if not entries or entries[0][0] != b'':
    raise BundleError(f'{prefix}.index: no header entry')
  header = tf_wire.BundleHeaderProto.FromString(entries[0][1])
  if header.num_shards != 1:
    raise BundleError(f'{prefix}: bundles of {header.num_shards} shards are '
                      'not read here')
  if header.endianness != 0:
    raise BundleError(f'{prefix}: big-endian bundles are not read here')
  tensors: Dict[str, BundleValue] = {}
  if len(entries) == 1:
    return header, tensors
  with open(data_path(prefix), 'rb') as f:
    shard = f.read()
  for key, value in entries[1:]:
    entry = tf_wire.BundleEntryProto.FromString(value)
    name = key.decode('utf-8')
    if entry.slices:
      raise BundleError(f'{name}: sliced tensors are not read here')
    chunk = shard[entry.offset:entry.offset + entry.size]
    if len(chunk) != entry.size:
      raise BundleError(f'{name}: past the end of the data shard')
    shape = tuple(int(d.size) for d in entry.shape.dim)
    count = int(np.prod(shape, dtype=np.int64))
    if entry.dtype == tf_wire.DT_STRING:
      if len(shape) > 1:
        raise BundleError(f'{name}: string tensors of rank {len(shape)} '
                          'are not read here')
      values = _read_string_tensor(chunk, count, entry.crc32c)
      tensors[name] = values if shape else values[0]
    else:
      if mask(_crc(chunk)) != entry.crc32c:
        raise BundleError(f'{name}: data checksum mismatch')
      dtype = tensorproto._DT_TO_NUMPY.get(entry.dtype)  # pylint: disable=protected-access
      if dtype is None:
        raise BundleError(f'{name}: dtype {entry.dtype} is not read here')
      tensors[name] = np.frombuffer(chunk, dtype).reshape(shape).copy()
  return header, tensors


def _shape(shape) -> tf_wire.TensorShapeProto:
  return tf_wire.TensorShapeProto(
      dim=[tf_wire.TensorShapeProtoDim(size=int(d)) for d in shape])


def write_bundle(prefix: str, tensors: Mapping[str, BundleValue]) -> None:
  """Writes `tensors` ({name: array, bytes for a scalar string tensor, or
  a list of bytes for a 1-D one}) as the bundle at `prefix`, as TF's
  BundleWriter lays it out."""
  os.makedirs(os.path.dirname(prefix) or '.', exist_ok=True)
  shard = bytearray()
  entries = [(b'', tf_wire.BundleHeaderProto(
      num_shards=1, version=tf_wire.VersionDef(producer=1)
  ).SerializeToString())]
  for name in sorted(tensors):
    value = tensors[name]
    if isinstance(value, (bytes, list)):
      values = [value] if isinstance(value, bytes) else list(value)
      data, crc = _string_tensor_bytes(values)
      shape = () if isinstance(value, bytes) else (len(values),)
      dtype = tf_wire.DT_STRING
    else:
      arr = np.ascontiguousarray(value)
      key = np.dtype(arr.dtype.str.lstrip('<=|'))
      dtype = tensorproto._NUMPY_KIND_TO_DT.get(key)  # pylint: disable=protected-access
      if dtype is None:
        raise BundleError(f'{name}: no TF dtype for {arr.dtype}')
      data = arr.astype(arr.dtype.newbyteorder('<'), copy=False).tobytes()
      crc = _crc(data)
      shape = arr.shape
    entry = tf_wire.BundleEntryProto(dtype=dtype, shape=_shape(shape),
                                     size=len(data), crc32c=mask(crc))
    if shard:
      entry.offset = len(shard)
    if not shape:
      entry.shape = tf_wire.TensorShapeProto()
    shard.extend(data)
    entries.append((name.encode('utf-8'), entry.SerializeToString()))
  write_table(f'{prefix}.index', entries)
  with open(data_path(prefix), 'wb') as f:
    f.write(bytes(shard))
