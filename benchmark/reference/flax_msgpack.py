"""A minimal msgpack reader for flax checkpoints (nested maps of arrays).

flax.serialization stores an array as msgpack ext type 1 (a 0-d numpy
scalar as ext type 3) whose payload is itself msgpack: [shape, dtype
name, raw bytes]. bfloat16 payloads are widened to float32.
"""

from __future__ import annotations

import struct

import numpy as np


def _read(buf: memoryview, pos: int):
  tag = buf[pos]
  pos += 1
  if tag <= 0x7F:
    return tag, pos
  if tag >= 0xE0:
    return tag - 0x100, pos
  if 0x80 <= tag <= 0x8F:
    return _map(buf, pos, tag & 0x0F)
  if 0x90 <= tag <= 0x9F:
    return _array(buf, pos, tag & 0x0F)
  if 0xA0 <= tag <= 0xBF:
    n = tag & 0x1F
    return str(buf[pos:pos + n], 'utf-8'), pos + n
  if tag == 0xC0:
    return None, pos
  if tag in (0xC2, 0xC3):
    return tag == 0xC3, pos
  fixed = {0xCA: '>f', 0xCB: '>d', 0xCC: '>B', 0xCD: '>H', 0xCE: '>I',
           0xCF: '>Q', 0xD0: '>b', 0xD1: '>h', 0xD2: '>i', 0xD3: '>q'}
  if tag in fixed:
    size = struct.calcsize(fixed[tag])
    return struct.unpack(fixed[tag], buf[pos:pos + size])[0], pos + size
  lengths = {0xC4: '>B', 0xC5: '>H', 0xC6: '>I', 0xD9: '>B', 0xDA: '>H',
             0xDB: '>I', 0xDC: '>H', 0xDD: '>I', 0xDE: '>H', 0xDF: '>I',
             0xC7: '>B', 0xC8: '>H', 0xC9: '>I'}
  if tag in lengths:
    size = struct.calcsize(lengths[tag])
    n = struct.unpack(lengths[tag], buf[pos:pos + size])[0]
    pos += size
    if tag in (0xC4, 0xC5, 0xC6):
      return bytes(buf[pos:pos + n]), pos + n
    if tag in (0xD9, 0xDA, 0xDB):
      return str(buf[pos:pos + n], 'utf-8'), pos + n
    if tag in (0xDC, 0xDD):
      return _array(buf, pos, n)
    if tag in (0xDE, 0xDF):
      return _map(buf, pos, n)
    return _ext(buf, pos, n)
  fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
  if tag in fixext:
    return _ext(buf, pos, fixext[tag])
  raise ValueError(f'msgpack: type byte 0x{tag:02x} is not supported')


def _array(buf, pos, n):
  out = []
  for _ in range(n):
    value, pos = _read(buf, pos)
    out.append(value)
  return out, pos


def _map(buf, pos, n):
  out = {}
  for _ in range(n):
    key, pos = _read(buf, pos)
    out[key], pos = _read(buf, pos)
  return out, pos


def _ext(buf, pos, n):
  code = struct.unpack('>b', buf[pos:pos + 1])[0]
  payload = buf[pos + 1:pos + 1 + n]
  if code not in (1, 3):
    raise ValueError(f'msgpack: ext type {code} is not supported')
  (shape, dtype, raw), _ = _read(payload, 0)
  if dtype == 'bfloat16':
    halves = np.frombuffer(raw, np.uint16).astype(np.uint32)
    array = (halves << 16).view(np.float32).reshape(shape)
  else:
    array = np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
  return (array if code == 1 else array[()]), pos + 1 + n


def load(path: str) -> dict:
  """The nested dict of numpy arrays stored in a flax msgpack file."""
  with open(path, 'rb') as f:
    data = memoryview(f.read())
  value, pos = _read(data, 0)
  if pos != len(data):
    raise ValueError(f'{path}: trailing bytes after the msgpack object')
  return value
