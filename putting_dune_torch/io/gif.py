"""Animated GIF89a, written and read by the port itself (no PIL, imageio
or matplotlib writer): what the episode videos are saved as.

`encode` writes palette-index frames with one global colour table (the
frames' shared `raster.Palette`), a per-frame delay of `interval_ms` and
the NETSCAPE2.0 extension that loops forever. The image data is LZW
compressed by `native/gif_lzw.cc` (through `io/native.py`); `lzw_encode_py`
is the same algorithm in Python, the oracle the tests hold the library to
byte for byte and far too slow for 250,000-pixel frames. A GIF holds at
most 256 colours and the canvas draws without antialiasing, so a decoded
frame equals the drawn one pixel for pixel.

`decode` reads GIFs of this kind back (global or local colour tables, no
interlacing): the tests and the smoke use it to check what was written.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import List, Optional, Sequence

import numpy as np

MAX_CODE = 4095


def _table_bits(colors: int) -> int:
  """N with 2^(N+1) table entries holding `colors`."""
  bits = 0
  while (2 << bits) < colors:
    bits += 1
  return bits


def lzw_encode(pixels: np.ndarray, min_code_size: int) -> bytes:
  """GIF LZW of flat uint8 palette indices, through the native library."""
  from putting_dune_torch.io import native

  data = np.ascontiguousarray(pixels, np.uint8).reshape(-1)
  cap = 2 * data.size + 16
  out = ctypes.create_string_buffer(cap)
  n = native.load().pd_gif_lzw_encode(data.tobytes(), data.size,
                                      min_code_size, out, cap)
  if n < 0:
    raise ValueError(f'gif_lzw: bad input (code {n}): indices must be < '
                     f'{1 << min_code_size}, min_code_size in 2..8')
  return out.raw[:n]


def lzw_encode_py(pixels: np.ndarray, min_code_size: int) -> bytes:
  """The plain twin of `lzw_encode` (giflib's code stream, see
  native/gif_lzw.cc)."""
  data = np.asarray(pixels, np.uint8).reshape(-1).tolist()
  clear = 1 << min_code_size
  eoi = clear + 1
  out = bytearray()
  acc = bits = 0
  state = {'next': clear + 2, 'width': min_code_size + 1}
  table: dict[int, int] = {}

  def put(code):
    nonlocal acc, bits
    acc |= code << bits
    bits += state['width']
    while bits >= 8:
      out.append(acc & 0xFF)
      acc >>= 8
      bits -= 8
    if state['next'] >= (1 << state['width']) and state['width'] < 12:
      state['width'] += 1

  if any(v >= clear for v in data):
    raise ValueError(f'indices must be < {clear}')
  put(clear)
  if data:
    prefix = data[0]
    for k in data[1:]:
      key = (prefix << 8) | k
      code = table.get(key)
      if code is not None:
        prefix = code
        continue
      put(prefix)
      prefix = k
      if state['next'] >= MAX_CODE:
        put(clear)
        state['next'] = clear + 2
        state['width'] = min_code_size + 1
        table.clear()
      else:
        table[key] = state['next']
        state['next'] += 1
    put(prefix)
  put(eoi)
  if bits:
    out.append(acc & 0xFF)
  return bytes(out)


def lzw_decode(data: bytes, min_code_size: int, count: int) -> np.ndarray:
  """`count` palette indices from GIF LZW data."""
  clear = 1 << min_code_size
  eoi = clear + 1
  out = bytearray()
  pos = 0  # bit position
  total = len(data) * 8
  width = min_code_size + 1
  table: List[bytes] = [bytes([i]) for i in range(clear)] + [b'', b'']
  prev: Optional[bytes] = None
  while pos + width <= total and len(out) < count:
    byte = pos >> 3
    chunk = int.from_bytes(data[byte:byte + 3], 'little')
    code = (chunk >> (pos & 7)) & ((1 << width) - 1)
    pos += width
    if code == clear:
      table = table[:clear + 2]
      width = min_code_size + 1
      prev = None
      continue
    if code == eoi:
      break
    if code < len(table):
      entry = table[code]
      if prev is not None and len(table) <= MAX_CODE:
        table.append(prev + entry[:1])
    elif prev is not None and code == len(table):
      entry = prev + prev[:1]
      table.append(entry)
    else:
      raise ValueError(f'GIF LZW: code {code} outside the table')
    out += entry
    prev = entry
    if len(table) == (1 << width) and width < 12:
      width += 1
  if len(out) < count:
    raise ValueError(f'GIF LZW: {len(out)} pixels, {count} expected')
  return np.frombuffer(bytes(out[:count]), np.uint8)


def _sub_blocks(data: bytes) -> bytes:
  parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
           for i in range(0, len(data), 255)]
  return b''.join(parts) + b'\x00'


def encode(frames: Sequence[np.ndarray], palette: np.ndarray,
           interval_ms: int = 200, loop: int = 0,
           compress=lzw_encode) -> bytes:
  """GIF89a bytes of (H, W) uint8 palette-index frames, `palette` (P, 3)
  uint8 with P <= 256 as the global colour table; each frame shows for
  `interval_ms` (written in hundredths of a second); `loop` 0 loops
  forever."""
  palette = np.asarray(palette, np.uint8).reshape(-1, 3)
  if not 1 <= len(palette) <= 256:
    raise ValueError(f'A GIF palette holds 1-256 colours, got {len(palette)}')
  if not frames:
    raise ValueError('A GIF needs at least one frame')
  height, width = frames[0].shape
  bits = _table_bits(len(palette))
  table = np.zeros((2 << bits, 3), np.uint8)
  table[:len(palette)] = palette
  min_code_size = max(2, bits + 1)
  delay = int(round(interval_ms / 10))
  out = [b'GIF89a',
         struct.pack('<HHBBB', width, height, 0x80 | (7 << 4) | bits, 0, 0),
         table.tobytes(),
         b'\x21\xff\x0bNETSCAPE2.0\x03\x01' + struct.pack('<H', loop)
         + b'\x00']
  for frame in frames:
    frame = np.asarray(frame)
    if frame.shape != (height, width) or frame.dtype != np.uint8:
      raise ValueError(f'GIF frames must all be ({height}, {width}) uint8')
    out.append(b'\x21\xf9\x04' + struct.pack('<BHB', 0x04, delay, 0)
               + b'\x00')
    out.append(b'\x2c' + struct.pack('<HHHHB', 0, 0, width, height, 0))
    out.append(bytes([min_code_size])
               + _sub_blocks(compress(frame, min_code_size)))
  out.append(b'\x3b')
  return b''.join(out)


@dataclasses.dataclass
class Gif:
  """A decoded GIF: `frames` holds the first `limit` frames as (H, W, 3)
  uint8 RGB, `count` and `delays_ms` cover every frame."""

  width: int
  height: int
  count: int
  delays_ms: List[int]
  loop: Optional[int]
  frames: List[np.ndarray]
  indices: List[np.ndarray]


def decode(data: bytes, limit: Optional[int] = None) -> Gif:
  """Reads a GIF87a/89a; decompresses the first `limit` frames (all by
  default) and counts the rest."""
  data = bytes(data)
  if data[:6] not in (b'GIF87a', b'GIF89a'):
    raise ValueError('Not a GIF')
  width, height, packed, _, _ = struct.unpack('<HHBBB', data[6:13])
  pos = 13
  global_table = None
  if packed & 0x80:
    size = 2 << (packed & 7)
    global_table = np.frombuffer(data[pos:pos + 3 * size],
                                 np.uint8).reshape(size, 3)
    pos += 3 * size
  gif = Gif(width, height, 0, [], None, [], [])
  delay = 0

  def blocks(pos):
    chunks = []
    while True:
      n = data[pos]
      pos += 1
      if n == 0:
        return b''.join(chunks), pos
      chunks.append(data[pos:pos + n])
      pos += n

  while pos < len(data):
    kind = data[pos]
    pos += 1
    if kind == 0x3B:
      return gif
    if kind == 0x21:
      label = data[pos]
      body, pos = blocks(pos + 1)
      if label == 0xF9:
        delay = struct.unpack('<H', body[1:3])[0] * 10
      elif label == 0xFF and body.startswith(b'NETSCAPE2.0'):
        gif.loop = struct.unpack('<H', body[-2:])[0]
      continue
    if kind != 0x2C:
      raise ValueError(f'GIF: unknown block 0x{kind:02x}')
    _, _, w, h, flags = struct.unpack('<HHHHB', data[pos:pos + 9])
    pos += 9
    table = global_table
    if flags & 0x80:
      size = 2 << (flags & 7)
      table = np.frombuffer(data[pos:pos + 3 * size],
                            np.uint8).reshape(size, 3)
      pos += 3 * size
    if flags & 0x40:
      raise ValueError('Interlaced GIF frames are not supported')
    min_code_size = data[pos]
    body, pos = blocks(pos + 1)
    if limit is None or gif.count < limit:
      idx = lzw_decode(body, min_code_size, w * h).reshape(h, w)
      gif.indices.append(idx)
      gif.frames.append(table[idx])
    gif.count += 1
    gif.delays_ms.append(delay)
  raise ValueError('GIF without a trailer')
