"""The port's host C++ codecs: built with g++ at first use.

`native/tfrecord.cc` (TFRecord framing, CRC32C), `native/riegeli_hash.cc`
(HighwayHash-64 over the vendored portable headers in
`native/third_party/highwayhash`), `native/gif_lzw.cc` (the GIF
compressor of the episode videos) and `native/jpeg.cc` (the JPEG decoder
of `io/jpeg.py`) build into one shared library in the
git-ignored `putting_dune_torch/_build/`, named by a hash of the sources,
the headers and the flags like the CUDA kernels (`ops/_build.py`), and load
through ctypes. A failed build raises: nothing falls back to the plain
Python twins (`crc32c_py` here, `riegeli_native.highwayhash64_py`,
`gif.lzw_encode_py`), which
are the oracles the tests hold the library to and read at a few MB/s.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG_DIR / 'native'
BUILD_DIR = _PKG_DIR / '_build'
SOURCES = ('tfrecord.cc', 'riegeli_hash.cc', 'gif_lzw.cc', 'jpeg.cc')
# -fno-strict-aliasing: hh_portable.h type-puns its u64 state as u32, which
# -O2 and above miscompile into wrong digests without it.
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-fno-strict-aliasing', '-shared')

_lib = None
_lock = threading.Lock()


def _inputs() -> list[pathlib.Path]:
  headers = sorted((NATIVE_DIR / 'third_party').rglob('*.h'))
  return [NATIVE_DIR / name for name in SOURCES] + headers


def library_path() -> pathlib.Path:
  digest = hashlib.sha256()
  for path in _inputs():
    digest.update(path.relative_to(NATIVE_DIR).as_posix().encode() + b'\0'
                  + path.read_bytes())
  digest.update(' '.join(CXX_FLAGS).encode())
  return BUILD_DIR / f'records-{digest.hexdigest()[:16]}.so'


def build() -> pathlib.Path:
  """Compiles the library if it is missing; returns its path. Raises
  RuntimeError with the compiler's output on failure."""
  out = library_path()
  if out.exists():
    return out
  cxx = os.environ.get('CXX') or shutil.which('g++') or shutil.which('c++')
  if cxx is None:
    raise RuntimeError('No C++ compiler (g++) to build the host codecs.')
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
  cmd = [cxx, *CXX_FLAGS, f'-I{NATIVE_DIR / "third_party" / "highwayhash"}',
         '-o', str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
  run = subprocess.run(cmd, capture_output=True, text=True)
  if run.returncode != 0:
    raise RuntimeError(
        f'Building the host codecs failed ({" ".join(cmd)}):\n'
        f'{run.stdout}{run.stderr}')
  os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
  return out


def load() -> ctypes.CDLL:
  """The loaded library, built on first use."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(build()))
      c_u64, c_u64_p = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
      lib.pd_tfrecord_write_many.argtypes = [
          ctypes.c_char_p, ctypes.c_char_p, c_u64_p, c_u64]
      lib.pd_tfrecord_write_many.restype = ctypes.c_int
      lib.pd_tfrecord_scan.argtypes = [ctypes.c_char_p, c_u64_p, c_u64_p]
      lib.pd_tfrecord_scan.restype = ctypes.c_int
      lib.pd_tfrecord_read.argtypes = [
          ctypes.c_char_p, ctypes.c_char_p, c_u64_p, c_u64, ctypes.c_int]
      lib.pd_tfrecord_read.restype = ctypes.c_int
      lib.pd_crc32c.argtypes = [ctypes.c_char_p, c_u64]
      lib.pd_crc32c.restype = ctypes.c_uint32
      lib.pd_highwayhash64.argtypes = [
          ctypes.POINTER(c_u64 * 4), ctypes.c_char_p, c_u64]
      lib.pd_highwayhash64.restype = c_u64
      lib.pd_gif_lzw_encode.argtypes = [
          ctypes.c_char_p, c_u64, ctypes.c_int, ctypes.c_char_p, c_u64]
      lib.pd_gif_lzw_encode.restype = ctypes.c_int64
      lib.pd_jpeg_header.argtypes = [
          ctypes.c_char_p, c_u64, ctypes.POINTER(ctypes.c_int32),
          ctypes.c_char_p, c_u64]
      lib.pd_jpeg_header.restype = ctypes.c_int
      lib.pd_jpeg_decode.argtypes = [
          ctypes.c_char_p, c_u64, ctypes.c_void_p, c_u64, ctypes.c_char_p,
          c_u64]
      lib.pd_jpeg_decode.restype = ctypes.c_int
      _lib = lib
    return _lib


def crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of `data`, unmasked."""
  return int(load().pd_crc32c(bytes(data), len(data)))


def highwayhash64(data: bytes, key) -> int:
  ckey = (ctypes.c_uint64 * 4)(*key)
  return int(load().pd_highwayhash64(ctypes.byref(ckey), data, len(data)))


# --- the plain twin ----------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
  _c = _i
  for _ in range(8):
    _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
  _CRC_TABLE.append(_c)
del _i, _c


def crc32c_py(data: bytes, crc: int = 0) -> int:
  """CRC32C (Castagnoli, reflected), one byte at a time."""
  crc ^= 0xFFFFFFFF
  table = _CRC_TABLE
  for byte in data:
    crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF
