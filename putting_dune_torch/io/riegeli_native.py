"""riegeli/records files, read and written without the `riegeli` package.

Port of putting_dune_tpu/io/riegeli_native.py. Upstream putting-dune's
microscope dumps are riegeli files written with the default
`riegeli.RecordWriter` options (brotli-compressed simple chunks). The
format:

  * the file is divided into 64 KiB blocks, each beginning with a 24-byte
    block header (header_hash u64, previous_chunk u64, next_chunk u64)
    that interrupts whatever chunk bytes span the boundary;
  * chunks are back to back: a 40-byte chunk header (header_hash u64,
    data_size u64, data_hash u64, chunk_type u8, num_records u56 LE,
    decoded_data_size u64) followed by data_size bytes of chunk data;
  * simple chunks (type 'r') hold records as: compression byte
    (0 none / 'b' brotli / 'z' zstd / 's' snappy), varint length of the
    compressed-sizes block, the sizes block (varint record sizes), then
    the concatenated record values. Compressed blocks are framed as
    varint(uncompressed_size) + raw compressed stream, sizes and values
    compressed independently;
  * transposed chunks (type 't'; RecordWriter transpose=true) store
    proto records column-wise and are decoded by replaying the encoder's
    state machine backward (see the transposed-chunks section below);
  * signature ('s'), file-metadata ('m') and padding ('p') chunks carry
    no records.

Every header carries HighwayHash-64 digests; reading checks all of them
by default, through the port's C++ codec (`io/native.py`, the vendored
google/highwayhash portable headers); `highwayhash64_py` is its plain
twin. The writer emits the signature and simple chunks, files the real
riegeli readers accept. (De)compression uses the system brotli, zstd and
snappy libraries through ctypes: a codec that is named but whose library
is missing raises; with none named, brotli is used when `libbrotlienc`
loads and the file is written uncompressed otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

from putting_dune_torch.io import native
from putting_dune_torch.proto import wire

BLOCK_SIZE = 1 << 16
BLOCK_HEADER_SIZE = 24
CHUNK_HEADER_SIZE = 40

# Chunk types (riegeli chunk.h).
CHUNK_SIGNATURE = 0x73  # 's'
CHUNK_FILE_METADATA = 0x6D  # 'm'
CHUNK_PADDING = 0x70  # 'p'
CHUNK_SIMPLE = 0x72  # 'r'
CHUNK_TRANSPOSED = 0x74  # 't'

COMPRESSION_NONE = 0x00
COMPRESSION_BROTLI = 0x62  # 'b'
COMPRESSION_ZSTD = 0x7A  # 'z'
COMPRESSION_SNAPPY = 0x73  # 's'


class RiegeliFormatError(ValueError):
  """The bytes do not parse as a riegeli/records file."""


class RiegeliUnsupportedError(NotImplementedError):
  """The file is (likely) valid but THIS environment cannot decode it.

  Raised when a required system decompression library is missing or a
  construct the decoder deliberately rejects is encountered; distinct from
  RiegeliFormatError (corrupt bytes).
  """


# --- HighwayHash-64 ----------------------------------------------------------
#
# riegeli headers carry HighwayHash-64 digests under the fixed key
# "Riegeli/" "records\n" repeated (little-endian u64s); coverage is: block
# header bytes [8,24), chunk header bytes [8,40), and the logical chunk
# data.

RIEGELI_HASH_KEY = (
    struct.unpack('<Q', b'Riegeli/')[0],
    struct.unpack('<Q', b'records\n')[0],
    struct.unpack('<Q', b'Riegeli/')[0],
    struct.unpack('<Q', b'records\n')[0],
)

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_HH_INIT0 = (0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0,
             0x13198A2E03707344, 0x243F6A8885A308D3)
_HH_INIT1 = (0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C,
             0xBE5466CF34E90C6C, 0x452821E638D01377)


def _rot64by32(x: int) -> int:
  return ((x >> 32) | (x << 32)) & _M64


def _hh_zipper(v1: int, v0: int) -> Tuple[int, int]:
  """ZipperMerge byte shuffle of a lane pair; returns (add1, add0)."""
  def m(v, b):
    return v & (0xFF << (b * 8))

  add0 = (((m(v0, 3) + m(v1, 4)) >> 24)
          + ((m(v0, 5) + m(v1, 6)) >> 16) + m(v0, 2)
          + ((m(v0, 1) << 32) & _M64) + (m(v1, 7) >> 8)
          + ((v0 << 56) & _M64)) & _M64
  add1 = (((m(v1, 3) + m(v0, 4)) >> 24) + m(v1, 2)
          + (m(v1, 5) >> 16) + ((m(v1, 1) << 24) & _M64)
          + (m(v0, 6) >> 8) + ((m(v1, 0) << 48) & _M64)
          + m(v0, 7)) & _M64
  return add1, add0


def highwayhash64_py(data: bytes, key=RIEGELI_HASH_KEY) -> int:
  """The plain twin: HighwayHash-64 in Python (google/highwayhash's
  portable algorithm)."""
  mul0 = list(_HH_INIT0)
  mul1 = list(_HH_INIT1)
  v0 = [_HH_INIT0[i] ^ key[i] for i in range(4)]
  v1 = [_HH_INIT1[i] ^ _rot64by32(key[i]) for i in range(4)]

  def update(lanes):
    for i in range(4):
      v1[i] = (v1[i] + lanes[i] + mul0[i]) & _M64
    for i in range(4):
      mul0[i] ^= ((v1[i] & _M32) * (v0[i] >> 32)) & _M64
      v0[i] = (v0[i] + mul1[i]) & _M64
      mul1[i] ^= ((v0[i] & _M32) * (v1[i] >> 32)) & _M64
    for dst, src in ((v0, v1), (v1, v0)):
      for lo in (0, 2):
        a1, a0 = _hh_zipper(src[lo + 1], src[lo])
        dst[lo + 1] = (dst[lo + 1] + a1) & _M64
        dst[lo] = (dst[lo] + a0) & _M64

  def update_packet(b):
    update([int.from_bytes(b[i * 8:(i + 1) * 8], 'little')
            for i in range(4)])

  n = len(data)
  rem = n & 31
  for off in range(0, n - rem, 32):
    update_packet(data[off:off + 32])
  if rem:
    tail = data[n - rem:]
    pair = ((rem << 32) + rem) & _M64
    for i in range(4):
      v0[i] = (v0[i] + pair) & _M64
    for i in range(4):  # rotate each 32-bit half of v1 left by rem
      lo, hi = v1[i] & _M32, v1[i] >> 32
      lo = ((lo << rem) | (lo >> (32 - rem))) & _M32
      hi = ((hi << rem) | (hi >> (32 - rem))) & _M32
      v1[i] = (hi << 32) | lo
    mod4 = rem & 3
    full = rem & ~3
    packet = bytearray(32)
    packet[:full] = tail[:full]
    if rem & 16:  # the last 4 input bytes, little-endian, at [28,32)
      packet[28:32] = tail[rem - 4:rem]
    elif mod4:  # Load3 AllowUnordered padding at [16,24)
      last3 = (tail[full] + (tail[full + (mod4 >> 1)] << 8)
               + (tail[full + mod4 - 1] << 16))
      packet[16:24] = last3.to_bytes(8, 'little')
    update_packet(bytes(packet))

  for _ in range(4):
    update([_rot64by32(v0[2]), _rot64by32(v0[3]),
            _rot64by32(v0[0]), _rot64by32(v0[1])])
  return (v0[0] + v1[0] + mul0[0] + mul1[0]) & _M64


def highwayhash64(data: bytes, key=RIEGELI_HASH_KEY) -> int:
  """HighwayHash-64 of data by the port's C++ codec."""
  return native.highwayhash64(data, key)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    if pos >= len(data):
      raise RiegeliFormatError('truncated varint')
    byte = data[pos]
    pos += 1
    result |= (byte & 0x7F) << shift
    if not byte & 0x80:
      return result, pos
    shift += 7
    if shift > 63:
      raise RiegeliFormatError('varint too long')


# --- system decompressors via ctypes ------------------------------------------


@functools.lru_cache(maxsize=None)
def _load(names: tuple):
  """dlopens (once per process) the first loadable of `names`.

  RTLD_DEEPBIND + RTLD_LOCAL: other extension modules in the process
  (e.g. the array_record wheel) statically embed their own brotli/zstd
  builds and export the symbols; without deep binding, the system
  library's internal cross-references can bind to those embedded copies,
  which corrupts state and segfaults (observed with
  tensorflow+array_record loaded before libbrotlienc).
  """
  mode = ctypes.DEFAULT_MODE
  deepbind = getattr(os, 'RTLD_DEEPBIND', 0)
  if deepbind:
    mode = os.RTLD_LOCAL | deepbind
  for name in names:
    try:
      return ctypes.CDLL(name, mode=mode)
    except OSError:
      continue
  return None


def _brotli_decompress(data: bytes, decoded_size: int) -> bytes:
  lib = _load(('libbrotlidec.so.1', 'libbrotlidec.so'))
  if lib is None:
    raise RiegeliUnsupportedError(
        'brotli-compressed riegeli chunk but libbrotlidec is unavailable'
    )
  lib.BrotliDecoderDecompress.argtypes = [
      ctypes.c_size_t,
      ctypes.c_char_p,
      ctypes.POINTER(ctypes.c_size_t),
      ctypes.c_char_p,
  ]
  lib.BrotliDecoderDecompress.restype = ctypes.c_int
  out = ctypes.create_string_buffer(max(decoded_size, 1))
  out_size = ctypes.c_size_t(decoded_size)
  # BROTLI_DECODER_RESULT_SUCCESS == 1.
  rc = lib.BrotliDecoderDecompress(
      len(data), data, ctypes.byref(out_size), out
  )
  if rc != 1 or out_size.value != decoded_size:
    raise RiegeliFormatError(
        f'brotli decompression failed (rc={rc}, got {out_size.value}, '
        f'want {decoded_size})'
    )
  return out.raw[:decoded_size]


def _zstd_decompress(data: bytes, decoded_size: int) -> bytes:
  lib = _load(('libzstd.so.1', 'libzstd.so'))
  if lib is None:
    raise RiegeliUnsupportedError(
        'zstd-compressed riegeli chunk but libzstd is unavailable'
    )
  lib.ZSTD_decompress.argtypes = [
      ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
  ]
  lib.ZSTD_decompress.restype = ctypes.c_size_t
  lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
  lib.ZSTD_isError.restype = ctypes.c_uint
  out = ctypes.create_string_buffer(max(decoded_size, 1))
  rc = lib.ZSTD_decompress(out, decoded_size, data, len(data))
  if lib.ZSTD_isError(rc) or rc != decoded_size:
    raise RiegeliFormatError(
        f'zstd decompression failed (rc={rc}, want {decoded_size})'
    )
  return out.raw[:decoded_size]


def _snappy_decompress(data: bytes, decoded_size: int) -> bytes:
  lib = _load(('libsnappy.so.1', 'libsnappy.so'))
  if lib is None:
    raise RiegeliUnsupportedError(
        'snappy-compressed riegeli chunk but libsnappy is unavailable'
    )
  lib.snappy_uncompress.argtypes = [
      ctypes.c_char_p,
      ctypes.c_size_t,
      ctypes.c_char_p,
      ctypes.POINTER(ctypes.c_size_t),
  ]
  lib.snappy_uncompress.restype = ctypes.c_int
  out = ctypes.create_string_buffer(max(decoded_size, 1))
  out_size = ctypes.c_size_t(decoded_size)
  rc = lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_size))
  if rc != 0 or out_size.value != decoded_size:
    raise RiegeliFormatError(f'snappy decompression failed (rc={rc})')
  return out.raw[:decoded_size]


# --- system compressors via ctypes -------------------------------------------


def _brotli_compress(data: bytes, quality: int = 6) -> Optional[bytes]:
  lib = _load(('libbrotlienc.so.1', 'libbrotlienc.so'))
  if lib is None:
    return None
  lib.BrotliEncoderCompress.argtypes = [
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_size_t, ctypes.c_char_p,
      ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
  ]
  lib.BrotliEncoderCompress.restype = ctypes.c_int
  lib.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
  lib.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
  bound = int(lib.BrotliEncoderMaxCompressedSize(len(data))) or (
      len(data) + 1024
  )
  out = ctypes.create_string_buffer(bound)
  out_size = ctypes.c_size_t(bound)
  # lgwin 22, mode 0 (GENERIC) — the brotli defaults.
  rc = lib.BrotliEncoderCompress(
      quality, 22, 0, len(data), data, ctypes.byref(out_size), out
  )
  if rc != 1:
    raise RiegeliFormatError(f'brotli compression failed (rc={rc})')
  return out.raw[:out_size.value]


def _zstd_compress(data: bytes, level: int = 3) -> Optional[bytes]:
  lib = _load(('libzstd.so.1', 'libzstd.so'))
  if lib is None:
    return None
  lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
  lib.ZSTD_compressBound.restype = ctypes.c_size_t
  lib.ZSTD_compress.argtypes = [
      ctypes.c_char_p, ctypes.c_size_t,
      ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
  ]
  lib.ZSTD_compress.restype = ctypes.c_size_t
  lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
  lib.ZSTD_isError.restype = ctypes.c_uint
  bound = int(lib.ZSTD_compressBound(len(data)))
  out = ctypes.create_string_buffer(max(bound, 1))
  rc = lib.ZSTD_compress(out, bound, data, len(data), level)
  if lib.ZSTD_isError(rc):
    raise RiegeliFormatError(f'zstd compression failed (rc={rc})')
  return out.raw[:rc]


def _snappy_compress(data: bytes) -> Optional[bytes]:
  lib = _load(('libsnappy.so.1', 'libsnappy.so'))
  if lib is None:
    return None
  lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
  lib.snappy_max_compressed_length.restype = ctypes.c_size_t
  lib.snappy_compress.argtypes = [
      ctypes.c_char_p, ctypes.c_size_t,
      ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
  ]
  lib.snappy_compress.restype = ctypes.c_int
  bound = int(lib.snappy_max_compressed_length(len(data)))
  out = ctypes.create_string_buffer(max(bound, 1))
  out_size = ctypes.c_size_t(bound)
  rc = lib.snappy_compress(data, len(data), out, ctypes.byref(out_size))
  if rc != 0:
    raise RiegeliFormatError(f'snappy compression failed (rc={rc})')
  return out.raw[:out_size.value]


def _decompress_block(
    compression: int, data: bytes, pos: int, end: int
) -> Tuple[bytes, int]:
  """Decodes one compressed block: varint(uncompressed size) + stream.

  Returns (decompressed bytes, new position). With COMPRESSION_NONE the
  block is raw and `end` bounds it.
  """
  if compression == COMPRESSION_NONE:
    return data[pos:end], end
  size, pos = _read_varint(data, pos)
  payload = data[pos:end]
  if compression == COMPRESSION_BROTLI:
    return _brotli_decompress(payload, size), end
  if compression == COMPRESSION_ZSTD:
    return _zstd_decompress(payload, size), end
  if compression == COMPRESSION_SNAPPY:
    return _snappy_decompress(payload, size), end
  # Unknown to this decoder, not necessarily corrupt: a newer writer may
  # use a compression code outside the spec revision implemented here.
  raise RiegeliUnsupportedError(
      f'unknown compression type 0x{compression:02x}'
  )


# --- block-aware logical reads -----------------------------------------------


def _skip_block_header(pos: int) -> int:
  """Block headers sit at every multiple of BLOCK_SIZE."""
  if pos % BLOCK_SIZE == 0:
    return pos + BLOCK_HEADER_SIZE
  return pos


def _logical_read(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
  """Reads n logical bytes starting at pos, skipping block headers."""
  out = bytearray()
  while len(out) < n:
    pos = _skip_block_header(pos)
    take = min(n - len(out), BLOCK_SIZE - pos % BLOCK_SIZE)
    piece = buf[pos:pos + take]
    if len(piece) < take:
      raise RiegeliFormatError(
          f'truncated file: wanted {n} bytes at {pos}, hit EOF'
      )
    out += piece
    pos += take
  return bytes(out), pos


def _decode_simple_chunk(
    data: bytes, num_records: int, decoded_data_size: int
) -> List[bytes]:
  """Decodes a simple chunk's data into its records (chunk type 'r')."""
  if not data:
    raise RiegeliFormatError('empty simple chunk')
  compression = data[0]
  sizes_len, pos = _read_varint(data, 1)
  sizes_block, pos = _decompress_block(
      compression, data, pos, pos + sizes_len
  )
  values, _ = _decompress_block(compression, data, pos, len(data))
  if len(values) != decoded_data_size:
    raise RiegeliFormatError(
        f'decoded values size {len(values)} != header '
        f'decoded_data_size {decoded_data_size}'
    )
  records = []
  spos = 0
  vpos = 0
  for _ in range(num_records):
    size, spos = _read_varint(sizes_block, spos)
    records.append(values[vpos:vpos + size])
    vpos += size
  if vpos != len(values):
    raise RiegeliFormatError(
        f'record sizes sum {vpos} != values size {len(values)}'
    )
  return records


# --- transposed chunks -------------------------------------------------------
#
# Transposed chunks (type 't', RecordWriter transpose=true) store proto
# records COLUMN-WISE: each distinct (message path, field tag, encoding)
# gets a state-machine node whose values across records live in one
# buffer; records are reconstructed by running the state machine
# backward (riegeli writes them with a backward writer, so buffers and
# the record sequence are back-to-front). The layout below was
# reverse-engineered from files produced by the real riegeli C++ writer
# (array_record wheel) over controlled inputs; tests/test_torch_records.py
# holds this decoder to the JAX package's on such files:
#
#   chunk data: compression_type (byte), varint header_size, header
#   block, then the buckets (bucket_sizes[i] bytes each), then the
#   transitions block (to end of data). Header/buckets/transitions are
#   standard compressed blocks (varint decoded size + stream; raw when
#   compression is none).
#
#   header: num_buckets, num_buffers, bucket_sizes[num_buckets]
#   (compressed byte counts), buffer_sizes[num_buffers] (decoded byte
#   counts; buffers fill buckets greedily in order), num_nodes N, then
#   N node tags, N node "next" codes, one subtype byte per varint
#   (wiretype-0) node, one buffer index per buffer-consuming node, and
#   the initial node index.
#
#   node tags: proto tag varints (>= 8) act on the wire tag; wiretype 6
#   (invalid in proto) marks "this length-delimited field is encoded as
#   a submessage" (real wiretype 2). Special ids: 0 = no-op,
#   1 = non-proto record (data buffer at index, record sizes in the
#   NEXT buffer), 2 = submessage start (emits tag + length), 3 = record
#   boundary.
#
#   node next codes: v >= N jumps statically to node v - N; v < N makes
#   the node DYNAMIC: it consumes a transition byte b and jumps to node
#   v + (b >> 2), then serves the next (b & 3) consultations with
#   delta 0 before reading another byte.
#
#   varint subtypes: 0..9 = value spans subtype+1 buffer bytes with
#   continuation bits stripped (the decoder restores them);
#   0x0a + v = value v inlined, no buffer bytes.

_WT_VARINT, _WT_FIXED64, _WT_DELIMITED, _WT_FIXED32 = 0, 1, 2, 5
_WT_SUBMESSAGE = 6  # riegeli-private marker, not a real proto wiretype
_NODE_NOOP, _NODE_NONPROTO, _NODE_SUBMSG_START, _NODE_RECORD = 0, 1, 2, 3
_SUBTYPE_INLINE_BASE = 0x0A


def _encode_varint(n: int) -> bytes:
  out = bytearray()
  while True:
    byte = n & 0x7F
    n >>= 7
    if n:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


class _BufferStream:
  __slots__ = ('data', 'pos')

  def __init__(self, data: bytes):
    self.data = data
    self.pos = 0

  def read(self, n: int) -> bytes:
    piece = self.data[self.pos:self.pos + n]
    if len(piece) < n:
      raise RiegeliFormatError('transposed chunk: buffer underrun')
    self.pos += n
    return piece

  def read_varint(self) -> int:
    value, self.pos = _read_varint(self.data, self.pos)
    return value


def _decode_transposed_chunk(
    data: bytes, num_records: int, decoded_data_size: int
) -> List[bytes]:
  """Decodes a transposed chunk's data into its records (chunk type 't')."""
  if not data:
    raise RiegeliFormatError('empty transposed chunk')
  compression = data[0]
  header_size, pos = _read_varint(data, 1)
  header, _ = _decompress_block(compression, data, pos, pos + header_size)
  pos += header_size

  h = 0
  num_buckets, h = _read_varint(header, h)
  num_buffers, h = _read_varint(header, h)
  bucket_sizes = []
  for _ in range(num_buckets):
    size, h = _read_varint(header, h)
    bucket_sizes.append(size)
  buffer_sizes = []
  for _ in range(num_buffers):
    size, h = _read_varint(header, h)
    buffer_sizes.append(size)

  # Decompress buckets and split them into buffers: buffers fill each
  # bucket greedily in order (a bucket's decoded size is an exact sum of
  # consecutive buffer sizes).
  buffers: List[_BufferStream] = []
  next_buffer = 0
  for size in bucket_sizes:
    bucket, _ = _decompress_block(compression, data, pos, pos + size)
    pos += size
    off = 0
    while next_buffer < num_buffers and (
        off + buffer_sizes[next_buffer] <= len(bucket)
    ):
      take = buffer_sizes[next_buffer]
      buffers.append(_BufferStream(bucket[off:off + take]))
      off += take
      next_buffer += 1
      if off == len(bucket) and not (
          next_buffer < num_buffers and buffer_sizes[next_buffer] == 0
      ):
        break
    if off != len(bucket):
      raise RiegeliFormatError(
          'transposed chunk: bucket does not split into whole buffers'
      )
  if next_buffer != num_buffers:
    raise RiegeliFormatError('transposed chunk: missing buffers')

  num_nodes, h = _read_varint(header, h)
  tags = []
  for _ in range(num_nodes):
    tag, h = _read_varint(header, h)
    tags.append(tag)
  nexts = []
  for _ in range(num_nodes):
    nxt, h = _read_varint(header, h)
    nexts.append(nxt)
  subtypes: List[Optional[int]] = []
  for tag in tags:
    if tag >= 8 and tag & 7 == _WT_VARINT:
      if h >= len(header):
        raise RiegeliFormatError('transposed chunk: truncated subtypes')
      subtypes.append(header[h])
      h += 1
    else:
      subtypes.append(None)
  node_buffers: List[Optional[_BufferStream]] = []
  nonproto_sizes = {}
  for i, (tag, subtype) in enumerate(zip(tags, subtypes)):
    needs_buffer = (
        tag == _NODE_NONPROTO
        or (
            tag >= 8
            and (
                (tag & 7 == _WT_VARINT and subtype < _SUBTYPE_INLINE_BASE)
                or tag & 7 in (_WT_FIXED64, _WT_DELIMITED, _WT_FIXED32)
            )
        )
    )
    if needs_buffer:
      index, h = _read_varint(header, h)
      if index >= num_buffers:
        raise RiegeliFormatError('transposed chunk: buffer index range')
      node_buffers.append(buffers[index])
      if tag == _NODE_NONPROTO:
        # Non-proto nodes read record bytes from buffer[index] and the
        # per-record sizes from the buffer AFTER it.
        if index + 1 >= num_buffers:
          raise RiegeliFormatError('transposed chunk: nonproto buffers')
        nonproto_sizes[i] = buffers[index + 1]
    else:
      node_buffers.append(None)
  init_node, h = _read_varint(header, h)
  if init_node >= num_nodes:
    raise RiegeliFormatError('transposed chunk: initial node out of range')

  transitions, _ = _decompress_block(compression, data, pos, len(data))

  # Run the state machine. Records come out back-to-front; each record's
  # pieces are collected in visit order and reversed on finalize (the
  # writer used a backward writer throughout).
  records: List[bytes] = []
  pieces: List[bytes] = []
  piece_bytes = 0
  submsg_stack: List[Tuple[int, int]] = []  # (real tag value, bytes mark)
  tpos = 0
  pending = 0

  def finalize():
    nonlocal pieces, piece_bytes
    if submsg_stack:
      raise RiegeliFormatError('transposed chunk: unterminated submessage')
    pieces.reverse()
    records.append(b''.join(pieces))
    pieces = []
    piece_bytes = 0

  node = init_node
  guard = 0
  max_steps = 8 * (num_records + decoded_data_size + 16)
  while len(records) < num_records:
    guard += 1
    if guard > max_steps:
      raise RiegeliFormatError('transposed chunk: state machine ran away')
    tag = tags[node]
    if tag >= 8:
      wiretype = tag & 7
      if wiretype == _WT_VARINT:
        subtype = subtypes[node]
        if subtype >= _SUBTYPE_INLINE_BASE:
          piece = _encode_varint(tag) + bytes(
              [subtype - _SUBTYPE_INLINE_BASE]
          )
        else:
          raw = bytearray(node_buffers[node].read(subtype + 1))
          for i in range(len(raw) - 1):  # restore continuation bits
            raw[i] |= 0x80
          piece = _encode_varint(tag) + bytes(raw)
      elif wiretype == _WT_FIXED64:
        piece = _encode_varint(tag) + node_buffers[node].read(8)
      elif wiretype == _WT_FIXED32:
        piece = _encode_varint(tag) + node_buffers[node].read(4)
      elif wiretype == _WT_DELIMITED:
        stream = node_buffers[node]
        length = stream.read_varint()
        piece = (
            _encode_varint(tag) + _encode_varint(length)
            + stream.read(length)
        )
      elif wiretype == _WT_SUBMESSAGE:
        # Marks the END (in record order) of a length-delimited field
        # encoded as a submessage; emits nothing, notes the position.
        submsg_stack.append(((tag & ~7) | _WT_DELIMITED, piece_bytes))
        piece = b''
      else:
        # Proto group wiretypes (3/4, deprecated since proto2) were never
        # observed from the real writer; fail as unsupported rather than
        # decode them wrong.
        raise RiegeliUnsupportedError(
            f'transposed chunk: unsupported wiretype {wiretype} '
            f'(tag {tag})'
        )
      pieces.append(piece)
      piece_bytes += len(piece)
    elif tag == _NODE_RECORD:
      finalize()
    elif tag == _NODE_NONPROTO:
      size = nonproto_sizes[node].read_varint()
      pieces.append(node_buffers[node].read(size))
      piece_bytes += size
      finalize()
    elif tag == _NODE_SUBMSG_START:
      if not submsg_stack:
        raise RiegeliFormatError('transposed chunk: submessage underflow')
      real_tag, mark = submsg_stack.pop()
      piece = _encode_varint(real_tag) + _encode_varint(piece_bytes - mark)
      pieces.append(piece)
      piece_bytes += len(piece)
    elif tag == _NODE_NOOP:
      pass
    else:
      raise RiegeliFormatError(
          f'transposed chunk: unknown special node tag {tag}'
      )

    if len(records) >= num_records:
      break
    nxt = nexts[node]
    if nxt >= num_nodes:  # static jump
      node = nxt - num_nodes
    else:  # dynamic: consume a transition byte relative to base `nxt`
      if pending:
        pending -= 1
        node = nxt
      else:
        if tpos >= len(transitions):
          raise RiegeliFormatError('transposed chunk: transitions underrun')
        byte = transitions[tpos]
        tpos += 1
        pending = byte & 3
        node = nxt + (byte >> 2)
      if node >= num_nodes:
        raise RiegeliFormatError('transposed chunk: jump out of range')

  records.reverse()
  total = sum(len(r) for r in records)
  if total != decoded_data_size:
    raise RiegeliFormatError(
        f'transposed chunk: decoded {total} bytes != header '
        f'decoded_data_size {decoded_data_size}'
    )
  return records


def read_riegeli_records(path: str, verify: bool = True) -> List[bytes]:
  """Reads every record from a riegeli/records file.

  Parses the chunk stream sequentially from offset 0. Signature,
  file-metadata and padding chunks are skipped; simple AND transposed
  chunks are decoded. With verify=True (default) every block-header,
  chunk-header and chunk-data HighwayHash is checked and a mismatch
  raises RiegeliFormatError.
  """
  with open(path, 'rb') as f:
    buf = f.read()
  if len(buf) < BLOCK_HEADER_SIZE + CHUNK_HEADER_SIZE:
    raise RiegeliFormatError(f'{path}: too short to be a riegeli file')

  if verify:
    for block in range(0, len(buf), BLOCK_SIZE):
      if block + BLOCK_HEADER_SIZE > len(buf):
        raise RiegeliFormatError(
            f'{path}: truncated block header at offset {block}'
        )
      stored = struct.unpack('<Q', buf[block:block + 8])[0]
      got = highwayhash64(buf[block + 8:block + BLOCK_HEADER_SIZE])
      if got != stored:
        raise RiegeliFormatError(
            f'{path}: block header hash mismatch at offset {block}'
        )

  records: List[bytes] = []
  pos = 0
  first = True
  while pos < len(buf):
    pos = _skip_block_header(pos)
    if pos >= len(buf):
      break
    header, data_start = _logical_read(buf, pos, CHUNK_HEADER_SIZE)
    (header_hash, data_size, data_hash) = struct.unpack(
        '<QQQ', header[:24]
    )
    chunk_type = header[24]
    num_records = int.from_bytes(header[25:32], 'little')
    decoded_data_size = struct.unpack('<Q', header[32:40])[0]
    if verify and highwayhash64(header[8:]) != header_hash:
      raise RiegeliFormatError(
          f'{path}: chunk header hash mismatch at offset {pos}'
      )

    if first:
      if chunk_type != CHUNK_SIGNATURE or data_size != 0:
        raise RiegeliFormatError(
            f'{path}: missing riegeli file-signature chunk '
            f'(type=0x{chunk_type:02x}, data_size={data_size})'
        )
      first = False

    data, pos = _logical_read(buf, data_start, data_size)
    if verify and highwayhash64(data) != data_hash:
      raise RiegeliFormatError(
          f'{path}: chunk data hash mismatch at offset {data_start}'
      )
    if chunk_type == CHUNK_SIMPLE:
      records.extend(
          _decode_simple_chunk(data, num_records, decoded_data_size)
      )
    elif chunk_type == CHUNK_TRANSPOSED:
      records.extend(
          _decode_transposed_chunk(data, num_records, decoded_data_size)
      )
    elif chunk_type in (
        CHUNK_SIGNATURE, CHUNK_FILE_METADATA, CHUNK_PADDING
    ):
      pass
    else:
      # See the compression case above: an unknown chunk type is a
      # construct this decoder does not implement, not corruption.
      raise RiegeliUnsupportedError(
          f'{path}: unknown chunk type 0x{chunk_type:02x} at {data_start}'
      )
  return records


# --- native writer -----------------------------------------------------------


_varint = _encode_varint  # writer-side alias; one varint encoder only


_COMPRESSION_BY_NAME = {
    'uncompressed': COMPRESSION_NONE,
    'brotli': COMPRESSION_BROTLI,
    'zstd': COMPRESSION_ZSTD,
    'snappy': COMPRESSION_SNAPPY,
}

_COMPRESSORS = {
    COMPRESSION_BROTLI: _brotli_compress,
    COMPRESSION_ZSTD: _zstd_compress,
    COMPRESSION_SNAPPY: _snappy_compress,
}


def _resolve_compression(compression: Optional[str]) -> int:
  """Maps a compression name to its code; None = brotli if available.

  Upstream's default RecordWriter options compress with brotli; without
  libbrotlienc the file is written uncompressed (still a valid riegeli
  file). An explicitly requested compression whose system library is
  missing raises RuntimeError rather than silently downgrading.
  """
  if compression is None:
    return (
        COMPRESSION_BROTLI
        if _brotli_compress(b'probe') is not None
        else COMPRESSION_NONE
    )
  try:
    code = _COMPRESSION_BY_NAME[compression]
  except KeyError:
    raise ValueError(
        f'unknown riegeli compression {compression!r}; one of '
        f'{sorted(_COMPRESSION_BY_NAME)}'
    ) from None
  if code != COMPRESSION_NONE and _COMPRESSORS[code](b'probe') is None:
    raise RuntimeError(
        f'riegeli compression {compression!r} was requested but its '
        'system compression library is not installed; install it or '
        "use compression='uncompressed'."
    )
  return code


def _encode_simple_chunk(
    payloads: Sequence[bytes], compression: int
) -> bytes:
  """Encodes one simple ('r') chunk: 40-byte header + chunk data."""
  sizes = b''.join(_varint(len(p)) for p in payloads)
  values = b''.join(payloads)
  if compression == COMPRESSION_NONE:
    data = bytes([COMPRESSION_NONE]) + _varint(len(sizes)) + sizes + values
  else:
    compress = _COMPRESSORS[compression]
    sizes_block = _varint(len(sizes)) + compress(sizes)
    values_block = _varint(len(values)) + compress(values)
    data = (
        bytes([compression])
        + _varint(len(sizes_block))
        + sizes_block
        + values_block
    )
  return _chunk_bytes(CHUNK_SIMPLE, data, len(payloads), len(values))


def _chunk_bytes(
    chunk_type: int, data: bytes, num_records: int, decoded_data_size: int
) -> bytes:
  """Assembles a chunk: header (with HighwayHashes) + data."""
  tail = (
      struct.pack('<QQ', len(data), highwayhash64(data))
      + bytes([chunk_type])
      + num_records.to_bytes(7, 'little')
      + struct.pack('<Q', decoded_data_size)
  )
  return struct.pack('<Q', highwayhash64(tail)) + tail + data


def write_riegeli_records(
    path: str,
    payloads: Sequence[bytes],
    compression: Optional[str] = None,
    chunk_target_bytes: int = 1 << 20,
) -> None:
  """Writes a riegeli/records file real riegeli readers accept.

  Stands in for the `riegeli` package's RecordWriter: signature chunk +
  simple chunks (records grouped up to chunk_target_bytes decoded),
  24-byte block headers interleaved at every 64 KiB file offset,
  HighwayHash digests in every header.
  compression: 'uncompressed' | 'brotli' | 'zstd' | 'snappy' | None
  (None = brotli when libbrotlienc exists, else uncompressed).

  The file streams out chunk-by-chunk (peak memory = one encoded chunk,
  not 2x the file): every block header's fields are local to the chunk
  being emitted — previous_chunk points back to that chunk's boundary
  and next_chunk forward to its end (the next chunk's boundary) — so
  headers can be finalized inline.
  """
  comp = _resolve_compression(compression)

  def chunks() -> Iterator[bytes]:
    yield _chunk_bytes(CHUNK_SIGNATURE, b'', 0, 0)
    group: List[bytes] = []
    group_bytes = 0
    for p in payloads:
      p = bytes(p)
      group.append(p)
      group_bytes += len(p)
      if group_bytes >= chunk_target_bytes:
        yield _encode_simple_chunk(group, comp)
        group, group_bytes = [], 0
    if group:
      yield _encode_simple_chunk(group, comp)

  with open(path, 'wb') as f:
    pos = 0
    for chunk in chunks():
      pos = _emit_chunk(f, pos, chunk)


def _emit_chunk(f, pos: int, chunk: bytes) -> int:
  """Writes one chunk starting at stream offset `pos` (its boundary),
  interleaving finalized block headers at every BLOCK_SIZE offset;
  returns the end offset (= the next chunk's boundary).

  Header fields: previous_chunk = distance back to the boundary at or
  before the block begin (0 when a chunk starts right after the header),
  next_chunk = distance forward to the first boundary strictly after it
  — for a header inside this chunk that is always this chunk's end.
  Semantics confirmed against real riegeli writer output.
  """
  start = pos
  # First pass: end offset including the headers this chunk straddles.
  p, remaining = pos, len(chunk)
  while remaining:
    if p % BLOCK_SIZE == 0:
      p += BLOCK_HEADER_SIZE
    take = min(remaining, BLOCK_SIZE - p % BLOCK_SIZE)
    p += take
    remaining -= take
  end = p
  # Second pass: write bytes with finalized headers inline.
  offset = 0
  while offset < len(chunk):
    if pos % BLOCK_SIZE == 0:
      body = struct.pack('<QQ', pos - start, end - pos)
      f.write(struct.pack('<Q', highwayhash64(body)) + body)
      pos += BLOCK_HEADER_SIZE
    take = min(len(chunk) - offset, BLOCK_SIZE - pos % BLOCK_SIZE)
    f.write(chunk[offset:offset + take])
    offset += take
    pos += take
  return end


# --- ArrayRecord files -------------------------------------------------------


def read_array_record(path: str, verify: bool = True) -> List[bytes]:
  """Reads the USER records of a .array_record file (tfds.data_source's
  storage format, google/array_record).

  An ArrayRecord file is a riegeli stream whose trailing chunks are
  bookkeeping: a footer chunk (one RiegeliFooterMetadata record carrying
  the total user-record count, then one ArrayRecordFooter per user chunk)
  and postscript copies. The flat riegeli record walk therefore returns
  user records FIRST, then the footer records; this helper locates the
  footer metadata (scanning from the end, validated by version==1 and a
  consistent count — wire layout per array_record cpp/layout.proto) and
  returns exactly the user records. A plain riegeli/records file without
  an ArrayRecord footer is returned unchanged.
  """
  records = read_riegeli_records(path, verify=verify)
  for i in range(len(records) - 1, -1, -1):
    try:
      msg = wire.RiegeliFooterMetadataCompat.FromString(records[i])
    except (wire.DecodeError, UnicodeDecodeError):  # not a footer record
      continue
    if not msg.HasField('array_record'):
      continue
    ar = msg.array_record
    if ar.version != 1 or not ar.HasField('num_records'):
      continue
    if ar.num_records <= i:
      return records[: ar.num_records]
  return records


def available_codecs() -> List[str]:
  """The compression names this machine can write (and read)."""
  return ['uncompressed'] + [
      name for name, code in _COMPRESSION_BY_NAME.items()
      if code != COMPRESSION_NONE and _COMPRESSORS[code](b'probe') is not None]
