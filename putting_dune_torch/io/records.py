"""Record files: TFRecord and riegeli, dispatched by extension.

Port of putting_dune_tpu/io/records.py. A TFRecord file is a sequence of
records, each an 8-byte little-endian length, the masked CRC32C of those 8
bytes, the payload and the masked CRC32C of the payload; the port's C++
codec (`io/native.py`) writes and reads it. `write_records` and
`read_records` take `.tfrecords` / `.tfrecord` and `.riegeli`
(`io/riegeli_native.py`) paths, and serialize the `microscope_data`
dataclasses through their `to_proto`, or wire messages, or raw bytes.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Optional, Sequence, Type, TypeVar

from putting_dune_torch.io import native

T = TypeVar('T')

TFRECORD_EXTENSIONS = ('.tfrecords', '.tfrecord')
RIEGELI_EXTENSION = '.riegeli'


def mask(crc: int) -> int:
  """TFRecord's masked CRC."""
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_py(payload: bytes) -> bytes:
  """One TFRecord record framed by the plain twin (pure-Python CRC32C)."""
  length = struct.pack('<Q', len(payload))
  return (length + struct.pack('<I', mask(native.crc32c_py(length)))
          + payload + struct.pack('<I', mask(native.crc32c_py(payload))))


def write_tfrecords(path: str, payloads: Sequence[bytes]) -> None:
  """Writes serialized records as a TFRecord file."""
  payloads = [bytes(p) for p in payloads]
  offsets = [0]
  for p in payloads:
    offsets.append(offsets[-1] + len(p))
  data = b''.join(payloads)
  rc = native.load().pd_tfrecord_write_many(
      os.fsencode(path), data, (ctypes.c_uint64 * len(offsets))(*offsets),
      len(payloads))
  if rc != 0:
    raise IOError(f'TFRecord write failed (rc={rc}) for {path}')


def _scan(path: str):
  num, total = ctypes.c_uint64(), ctypes.c_uint64()
  rc = native.load().pd_tfrecord_scan(os.fsencode(path), ctypes.byref(num),
                                      ctypes.byref(total))
  if rc != 0:
    raise IOError(f'TFRecord scan failed (rc={rc}) for {path}')
  return int(num.value), int(total.value)


def count_tfrecords(path: str) -> int:
  """The number of records, from the headers alone."""
  return _scan(path)[0]


def read_tfrecords(path: str, verify_crc: bool = True) -> List[bytes]:
  """Every record of a TFRecord file; with verify_crc (the default) a
  length or payload whose CRC disagrees raises IOError."""
  num, total = _scan(path)
  buf = ctypes.create_string_buffer(max(total, 1))
  offsets = (ctypes.c_uint64 * (num + 1))()
  rc = native.load().pd_tfrecord_read(os.fsencode(path), buf, offsets, num,
                                      1 if verify_crc else 0)
  if rc != 0:
    what = {2: 'truncated record', 3: 'length CRC mismatch',
            4: 'payload CRC mismatch'}.get(rc, 'cannot open')
    raise IOError(f'TFRecord read failed (rc={rc}: {what}) for {path}')
  raw = buf.raw
  return [raw[offsets[i]:offsets[i + 1]] for i in range(num)]


def _payload(record) -> bytes:
  if isinstance(record, (bytes, bytearray, memoryview)):
    return bytes(record)
  if hasattr(record, 'to_proto_bytes'):
    return record.to_proto_bytes()
  if hasattr(record, 'SerializeToString'):
    return record.SerializeToString()
  raise TypeError(f'Cannot serialize record of type {type(record)}')


def write_records(path: str, records: Sequence) -> None:
  """Serializes records to a file, by its extension (riegeli: brotli when
  the system library loads, else uncompressed)."""
  payloads = [_payload(r) for r in records]
  ext = os.path.splitext(path)[1]
  if ext in TFRECORD_EXTENSIONS:
    write_tfrecords(path, payloads)
  elif ext == RIEGELI_EXTENSION:
    from putting_dune_torch.io import riegeli_native

    riegeli_native.write_riegeli_records(path, payloads)
  else:
    raise ValueError(f'Unsupported record extension: {ext}')


def read_records(path: str, record_cls: Optional[Type[T]] = None) -> List:
  """Every record of a file, by its extension; decoded through
  `record_cls.from_proto_bytes` when a class is given."""
  ext = os.path.splitext(path)[1]
  if ext in TFRECORD_EXTENSIONS:
    payloads = read_tfrecords(path)
  elif ext == RIEGELI_EXTENSION:
    from putting_dune_torch.io import riegeli_native

    payloads = riegeli_native.read_riegeli_records(path)
  else:
    raise ValueError(f'Unsupported record extension: {ext}')
  if record_cls is None:
    return payloads
  return [record_cls.from_proto_bytes(p) for p in payloads]
