"""A JPEG decoder of the port's own, in place of `cv2.imdecode`.

`imdecode(data)` returns what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`
returns for the JPEGs TFDS image features hold, pixel for pixel: (H, W)
uint8 for grey, (H, W, 3) uint8 BGR for colour; the EXIF orientation is
not applied, as IMREAD_UNCHANGED does not apply it. The decoding is
`native/jpeg.cc` (built into the host codecs' library by `io/native.py`):
8-bit sequential and progressive Huffman JPEG, 1 or 3 components with
sampling ratios 1 or 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals,
with libjpeg's integer IDCT, fancy upsampling and YCbCr tables.

Refused with ValueError (ROADMAP queue 1): arithmetic coding, 12-bit
samples, lossless and hierarchical JPEG, Adobe CMYK / YCCK and other
component counts, other sampling ratios. Malformed data raises ValueError
too. A failed build of the library raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from putting_dune_torch.io import native

SIGNATURE = b'\xff\xd8\xff'
_REFUSED, _MALFORMED = 1, 2


def is_jpeg(data: bytes) -> bool:
  return bytes(data[:3]) == SIGNATURE


def _raise(code: int, err: ctypes.Array) -> None:
  msg = err.value.decode(errors='replace')
  if code == _REFUSED:
    raise ValueError(f'{msg}: not decoded by the port (ROADMAP queue 1, IO: '
                     'JPEG kinds the port refuses)')
  raise ValueError(f'malformed JPEG: {msg}')


def header(data: bytes) -> tuple[int, int, int]:
  """(height, width, channels) of the decoded image."""
  data = bytes(data)
  lib = native.load()
  out = (ctypes.c_int32 * 3)()
  err = ctypes.create_string_buffer(256)
  code = lib.pd_jpeg_header(data, len(data), out, err, len(err))
  if code:
    _raise(code, err)
  return int(out[0]), int(out[1]), int(out[2])


def imdecode(data: bytes) -> np.ndarray:
  """The JPEG's pixels as cv2.IMREAD_UNCHANGED gives them (BGR order)."""
  data = bytes(data)
  height, width, channels = header(data)
  shape = (height, width) if channels == 1 else (height, width, channels)
  pixels = np.empty(shape, np.uint8)
  err = ctypes.create_string_buffer(256)
  code = native.load().pd_jpeg_decode(
      data, len(data), pixels.ctypes.data, pixels.nbytes, err, len(err))
  if code:
    _raise(code, err)
  return pixels
