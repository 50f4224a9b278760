"""A PNG codec of the port's own, in place of `cv2.imdecode` and
matplotlib's `savefig`.

Decodes what TFDS image features hold: non-interlaced PNG of 8- or 16-bit
samples, grey (colour type 0), RGB (2) or RGBA (6); zlib-compressed IDAT
data unfiltered by the five row filters (None, Sub, Up, Average, Paeth).
`imdecode` returns what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)` returns:
(H, W) for grey, (H, W, 3) BGR and (H, W, 4) BGRA, as uint8 or uint16.
Every chunk's CRC is checked. Anything else raises ValueError: palette and
grey-alpha images, bit depths below 8, interlacing, and any payload that is
not a PNG (JPEG decoding is not ported: ROADMAP queue 1, IO).

`imencode(rgb)` writes an 8-bit RGB (or grey) PNG through the standard
library's zlib, every row with filter 0: what the port's plots are saved
as.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
  pos = len(SIGNATURE)
  while pos + 12 <= len(data):
    (length,) = struct.unpack('>I', data[pos:pos + 4])
    kind = data[pos + 4:pos + 8]
    body = data[pos + 8:pos + 8 + length]
    (crc,) = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
    if len(body) != length:
      raise ValueError('PNG chunk runs past the end of the data')
    if zlib.crc32(kind + body) != crc:
      raise ValueError(f'PNG chunk {kind!r}: CRC mismatch')
    yield kind, body
    if kind == b'IEND':
      return
    pos += 12 + length
  raise ValueError('PNG without an IEND chunk')


def _paeth(a: int, b: int, c: int) -> int:
  p = a + b - c
  pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
  if pa <= pb and pa <= pc:
    return a
  return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
  """The scanlines' bytes (height, stride) with the row filters undone."""
  if len(raw) != height * (stride + 1):
    raise ValueError(f'PNG image data holds {len(raw)} bytes, '
                     f'{height * (stride + 1)} expected')
  rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
  out = np.zeros((height, stride), np.uint8)
  prev = np.zeros(stride, np.uint8)
  for y in range(height):
    kind, line = int(rows[y, 0]), rows[y, 1:]
    if kind == 0:
      cur = line.copy()
    elif kind == 2:  # Up
      cur = line + prev
    elif kind == 1:  # Sub: a running sum mod 256 over each byte lane
      lanes = line.astype(np.uint32).reshape(-1, bpp)
      cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    elif kind in (3, 4):
      cur_b = bytearray(line.tobytes())
      up = prev.tobytes()
      for x in range(stride):
        left = cur_b[x - bpp] if x >= bpp else 0
        if kind == 3:  # Average
          pred = (left + up[x]) >> 1
        else:  # Paeth
          pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
        cur_b[x] = (cur_b[x] + pred) & 0xFF
      cur = np.frombuffer(bytes(cur_b), np.uint8)
    else:
      raise ValueError(f'PNG row filter {kind} is not one of 0-4')
    out[y] = cur
    prev = out[y]
  return out


def imdecode(data: bytes) -> np.ndarray:
  """A PNG's pixels as cv2.IMREAD_UNCHANGED gives them (BGR order)."""
  data = bytes(data)
  if not data.startswith(SIGNATURE):
    kind = 'JPEG' if data[:3] == b'\xff\xd8\xff' else 'not a PNG'
    raise ValueError(
        f'Image feature bytes are {kind}: the port decodes PNG only (JPEG '
        'decoding is not ported: ROADMAP queue 1, IO).')
  header, idat = None, []
  for kind, body in _chunks(data):
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif kind == b'IDAT':
      idat.append(body)
  if header is None:
    raise ValueError('PNG without an IHDR chunk')
  width, height, depth, color, compression, filtering, interlace = header
  if color not in _CHANNELS:
    raise ValueError(f'PNG colour type {color} is not supported (grey, RGB '
                     'and RGBA are)')
  if depth not in (8, 16):
    raise ValueError(f'PNG bit depth {depth} is not supported (8 and 16 are)')
  if compression or filtering or interlace:
    raise ValueError('Interlaced or non-standard PNGs are not supported')
  channels = _CHANNELS[color]
  bpp = channels * depth // 8
  rows = _unfilter(zlib.decompress(b''.join(idat)), height, width * bpp, bpp)
  if depth == 16:
    pixels = rows.view('>u2').astype(np.uint16)
  else:
    pixels = rows
  pixels = pixels.reshape(height, width, channels)
  if channels == 1:
    return np.ascontiguousarray(pixels[..., 0])
  order = [2, 1, 0] + ([3] if channels == 4 else [])
  return np.ascontiguousarray(pixels[..., order])


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack('>I', len(body)) + kind + body
          + struct.pack('>I', zlib.crc32(kind + body)))


def imencode(pixels: np.ndarray) -> bytes:
  """An (H, W, 3) RGB or (H, W) grey uint8 array as PNG bytes (the RGB
  order PIL and matplotlib write; `imdecode` gives it back as BGR)."""
  pixels = np.ascontiguousarray(pixels)
  if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
      pixels.ndim == 3 and pixels.shape[2] != 3):
    raise ValueError(f'imencode takes (H, W) or (H, W, 3) uint8, got '
                     f'{pixels.shape} {pixels.dtype}')
  height, width = pixels.shape[:2]
  color = 0 if pixels.ndim == 2 else 2
  rows = pixels.reshape(height, -1)
  raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
  header = struct.pack('>IIBBBBB', width, height, 8, color, 0, 0, 0)
  return (SIGNATURE + _chunk(b'IHDR', header)
          + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
          + _chunk(b'IEND', b''))
