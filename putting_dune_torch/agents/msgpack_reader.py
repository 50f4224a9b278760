"""A small pure-Python msgpack reader for flax checkpoints.

flax.serialization writes nested maps whose array leaves are msgpack ext
type 1 payloads, themselves msgpack-encoded (shape, dtype_name, raw
bytes); numpy scalars are ext type 3 with the same payload (a 0-d
array). This reader returns nested dicts of numpy arrays, so the port can
load the shipped weights without msgpack or flax installed. numpy has no
bfloat16, so arrays stored in that type come back widened to float32
(exactly: a bfloat16 is the upper half of a float32).

Supported: nil, bool, int, float, str, bin, array, map, ext.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:

  def __init__(self, data: bytes):
    self.data = memoryview(data)
    self.pos = 0

  def take(self, n: int) -> memoryview:
    if self.pos + n > len(self.data):
      raise ValueError('msgpack: truncated input')
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def unpack(self, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, self.take(size))[0]

  def read(self):
    tag = self.unpack('>B')
    if tag <= 0x7F:
      return tag
    if tag >= 0xE0:
      return tag - 0x100
    if 0x80 <= tag <= 0x8F:
      return self.read_map(tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
      return self.read_array(tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
      return str(self.take(tag & 0x1F), 'utf-8')
    simple = {
        0xC0: lambda: None,
        0xC2: lambda: False,
        0xC3: lambda: True,
        0xC4: lambda: bytes(self.take(self.unpack('>B'))),
        0xC5: lambda: bytes(self.take(self.unpack('>H'))),
        0xC6: lambda: bytes(self.take(self.unpack('>I'))),
        0xC7: lambda: self.read_ext(self.unpack('>B')),
        0xC8: lambda: self.read_ext(self.unpack('>H')),
        0xC9: lambda: self.read_ext(self.unpack('>I')),
        0xCA: lambda: self.unpack('>f'),
        0xCB: lambda: self.unpack('>d'),
        0xCC: lambda: self.unpack('>B'),
        0xCD: lambda: self.unpack('>H'),
        0xCE: lambda: self.unpack('>I'),
        0xCF: lambda: self.unpack('>Q'),
        0xD0: lambda: self.unpack('>b'),
        0xD1: lambda: self.unpack('>h'),
        0xD2: lambda: self.unpack('>i'),
        0xD3: lambda: self.unpack('>q'),
        0xD4: lambda: self.read_ext(1),
        0xD5: lambda: self.read_ext(2),
        0xD6: lambda: self.read_ext(4),
        0xD7: lambda: self.read_ext(8),
        0xD8: lambda: self.read_ext(16),
        0xD9: lambda: str(self.take(self.unpack('>B')), 'utf-8'),
        0xDA: lambda: str(self.take(self.unpack('>H')), 'utf-8'),
        0xDB: lambda: str(self.take(self.unpack('>I')), 'utf-8'),
        0xDC: lambda: self.read_array(self.unpack('>H')),
        0xDD: lambda: self.read_array(self.unpack('>I')),
        0xDE: lambda: self.read_map(self.unpack('>H')),
        0xDF: lambda: self.read_map(self.unpack('>I')),
    }
    if tag not in simple:
      raise ValueError(f'msgpack: unsupported type byte 0x{tag:02x}')
    return simple[tag]()

  def read_array(self, n: int) -> list:
    return [self.read() for _ in range(n)]

  def read_map(self, n: int) -> dict:
    out = {}
    for _ in range(n):
      key = self.read()
      out[key] = self.read()
    return out

  def read_ext(self, n: int):
    code = self.unpack('>b')
    payload = bytes(self.take(n))
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
      shape, dtype, buf = unpackb(payload)
      if dtype == 'bfloat16':
        halves = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32)
        array = (halves << 16).view(np.float32).reshape(shape)
      else:
        array = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
      return array if code == _EXT_NDARRAY else array[()]
    raise ValueError(f'msgpack: unsupported ext type {code}')


def unpackb(data: bytes):
  """Decodes one msgpack object from bytes."""
  reader = _Reader(data)
  value = reader.read()
  if reader.pos != len(reader.data):
    raise ValueError('msgpack: trailing bytes after the object')
  return value
