"""msgpack writing and the two array layouts the JAX package stores.

Port of putting_dune_tpu/io/serialization.py, plus the writer the port
needs because the card's machine has no `msgpack` package (reading is
`agents/msgpack_reader.py`). Two layouts:

  * flax checkpoints (`to_bytes`): nested maps in the dict's own key order,
    as `flax.serialization.to_bytes` writes them, ndarray leaves as ext type 1
    (numpy scalars ext type 3) whose payload is the msgpack array
    (shape, dtype name, raw C-order bytes);
  * msgpack-numpy arrays (`msgpack_encode` / `msgpack_decode`), the GMM
    bundle's layout: {b'nd': True, b'type': dtype.str, b'kind': b'',
    b'shape': [...], b'data': raw bytes}.

Supported: None, bool, int, float (as float64), str, bytes, list, tuple,
dict, and whatever `default` turns into one of these or an `ExtType`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Callable, Optional

import numpy as np

# Reading, flax checkpoints included: the nested dict of numpy arrays.
from putting_dune_torch.agents.msgpack_reader import unpackb  # noqa: F401

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_LEGACY_KEY = '__ndarray__'


@dataclasses.dataclass(frozen=True)
class ExtType:
  code: int
  data: bytes


def _pack_len(out: bytearray, n: int, fix: Optional[tuple[int, int]],
              tags: tuple[int, int, int]) -> None:
  """Writes a length header: a fix form below its limit, else the 8-, 16-
  or 32-bit form (tags[0] may be None where the type has no 8-bit form)."""
  if fix is not None and n < fix[1]:
    out.append(fix[0] | n)
  elif tags[0] is not None and n < 2**8:
    out += struct.pack('>BB', tags[0], n)
  elif n < 2**16:
    out += struct.pack('>BH', tags[1], n)
  elif n < 2**32:
    out += struct.pack('>BI', tags[2], n)
  else:
    raise ValueError('msgpack: object too large')


def _pack_int(out: bytearray, v: int) -> None:
  if 0 <= v < 128:
    out.append(v)
  elif -32 <= v < 0:
    out.append(v & 0xFF)
  elif v >= 0:
    for tag, fmt, limit in ((0xCC, '>BB', 2**8), (0xCD, '>BH', 2**16),
                            (0xCE, '>BI', 2**32), (0xCF, '>BQ', 2**64)):
      if v < limit:
        out += struct.pack(fmt, tag, v)
        return
    raise ValueError('msgpack: integer too large')
  else:
    for tag, fmt, limit in ((0xD0, '>Bb', 2**7), (0xD1, '>Bh', 2**15),
                            (0xD2, '>Bi', 2**31), (0xD3, '>Bq', 2**63)):
      if v >= -limit:
        out += struct.pack(fmt, tag, v)
        return
    raise ValueError('msgpack: integer too small')


def _pack(out: bytearray, obj: Any, default: Optional[Callable]) -> None:
  if obj is None:
    out.append(0xC0)
  elif obj is True or obj is False:
    out.append(0xC3 if obj else 0xC2)
  elif type(obj) is int:
    _pack_int(out, obj)
  elif type(obj) is float:
    out += struct.pack('>Bd', 0xCB, obj)
  elif type(obj) is str:
    data = obj.encode('utf-8')
    _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
    out += data
  elif type(obj) in (bytes, bytearray, memoryview):
    data = bytes(obj)
    _pack_len(out, len(data), None, (0xC4, 0xC5, 0xC6))
    out += data
  elif type(obj) in (list, tuple):
    _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
    for item in obj:
      _pack(out, item, default)
  elif type(obj) is dict:
    _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
    for key, value in obj.items():
      _pack(out, key, default)
      _pack(out, value, default)
  elif isinstance(obj, ExtType):
    n = len(obj.data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
      out.append(fixed[n])
    else:
      _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack('>b', obj.code)
    out += obj.data
  elif default is not None:
    _pack(out, default(obj), None)
  else:
    raise TypeError(f'msgpack: cannot pack {type(obj)}')


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
  """Encodes one object as msgpack bytes (strict types: a subclass of a
  supported type goes through `default`, as msgpack's strict_types)."""
  out = bytearray()
  _pack(out, obj, default)
  return bytes(out)


# --- flax checkpoints ------------------------------------------------------


def _flax_ext(obj):
  array = np.asarray(obj)
  payload = packb((list(array.shape), array.dtype.name, array.tobytes('C')))
  return ExtType(_EXT_NPSCALAR if isinstance(obj, np.generic)
                 else _EXT_NDARRAY, payload)


def _str_keys(tree):
  if isinstance(tree, dict):
    return {str(k): _str_keys(v) for k, v in tree.items()}
  return tree


def to_bytes(tree) -> bytes:
  """`flax.serialization.to_bytes` of a nested dict of numpy arrays."""
  return packb(_str_keys(tree), default=_flax_ext)


# --- a trained model's artifacts in a workdir --------------------------------
# `params.msgpack` (the flax bytes both packages read and write) and the
# `arch.json` sidecar of the perception models.


def _key_sorted(tree):
  if isinstance(tree, dict):
    return {k: _key_sorted(tree[k]) for k in sorted(tree)}
  return tree


def write_params(params, workdir: str) -> str:
  """Writes a flax tree to `workdir`/params.msgpack, keys sorted as the
  JAX package's `jax.device_get(params)` leaves them; returns the path."""
  path = os.path.join(workdir, 'params.msgpack')
  with open(path, 'wb') as f:
    f.write(to_bytes(_key_sorted(params)))
  return path


def read_params_msgpack(workdir: str) -> Optional[dict]:
  """The flax tree in `workdir`/params.msgpack (float32 numpy leaves), or
  None when there is no such file."""
  path = os.path.join(workdir, 'params.msgpack')
  if not os.path.exists(path):
    return None
  with open(path, 'rb') as f:
    return unpackb(f.read())


def write_arch(workdir: str, arch: dict) -> None:
  with open(os.path.join(workdir, 'arch.json'), 'w') as f:
    json.dump(arch, f)


def load_arch(workdir: str) -> Optional[dict]:
  """Reads the arch.json sidecar ({'features', 'image_size'}, and the
  aligner's 'num_frames') if present."""
  path = os.path.join(workdir, 'arch.json')
  if not os.path.exists(path):
    return None
  with open(path) as f:
    return json.load(f)


# --- msgpack-numpy arrays --------------------------------------------------


def msgpack_encode(obj):
  """`default=` hook writing numpy arrays in the msgpack-numpy layout and
  numpy scalars as Python numbers."""
  if isinstance(obj, np.ndarray):
    if obj.dtype.kind == 'O':
      raise TypeError('object arrays are not msgpack-serializable')
    return {
        b'nd': True,
        b'type': obj.dtype.str,
        b'kind': b'',
        b'shape': list(obj.shape),
        b'data': np.ascontiguousarray(obj).tobytes(),
    }
  if isinstance(obj, np.generic):
    return obj.item()
  raise TypeError(f'Cannot msgpack-encode object of type {type(obj)}')


def _get(obj, name):
  if name in obj:
    return obj[name]
  alt = name.decode() if isinstance(name, bytes) else name.encode()
  return obj[alt]


def msgpack_decode(obj):
  """Turns one msgpack-numpy array map (or the legacy '__ndarray__'
  layout) back into an array; returns anything else unchanged."""
  if not isinstance(obj, dict):
    return obj
  try:
    if _get(obj, b'nd') is True:
      return (np.frombuffer(_get(obj, b'data'),
                            dtype=np.dtype(_get(obj, b'type')))
              .reshape(_get(obj, b'shape')).copy())
    if _get(obj, b'nd') is False:  # msgpack-numpy's scalar form
      return np.frombuffer(_get(obj, b'data'),
                           dtype=np.dtype(_get(obj, b'type')))[0]
  except KeyError:
    pass
  try:
    if _get(obj, _LEGACY_KEY):
      return np.frombuffer(_get(obj, 'data'),
                           dtype=np.dtype(_get(obj, 'dtype'))
                           ).reshape(_get(obj, 'shape'))
  except KeyError:
    pass
  return obj


def msgpack_decode_tree(obj):
  """`msgpack_decode` applied bottom-up, as msgpack's `object_hook` does."""
  if isinstance(obj, dict):
    return msgpack_decode({k: msgpack_decode_tree(v) for k, v in obj.items()})
  if isinstance(obj, list):
    return [msgpack_decode_tree(v) for v in obj]
  return obj
