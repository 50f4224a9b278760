"""`tensorflow.TensorProto` image payloads without TensorFlow.

Port of putting_dune_tpu/io/tensorproto.py on the port's wire codec. The
upstream putting-dune records store observation and transition images as
`tensorflow.TensorProto` submessages (tf.make_tensor_proto /
tf.make_ndarray); the JAX package writes its own `NDArray` by default. The
image fields are declared `bytes`, so the raw submessage survives the outer
parse; `decode_image_bytes` sniffs which of the two a payload is and
`encode_image_bytes` writes either.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from putting_dune_torch.proto import wire

# tensorflow.DataType enum values (tensorflow/core/framework/types.proto)
# of the dense numeric dtypes tf.make_tensor_proto emits.
_DT_FLOAT = 1
_DT_DOUBLE = 2
_DT_INT32 = 3
_DT_UINT8 = 4
_DT_INT16 = 5
_DT_INT8 = 6
_DT_STRING = 7
_DT_INT64 = 9
_DT_BOOL = 10
_DT_UINT16 = 17
_DT_HALF = 19
_DT_UINT32 = 22
_DT_UINT64 = 23

_DT_TO_NUMPY = {
    _DT_FLOAT: np.dtype('<f4'),
    _DT_DOUBLE: np.dtype('<f8'),
    _DT_INT32: np.dtype('<i4'),
    _DT_UINT8: np.dtype('u1'),
    _DT_INT16: np.dtype('<i2'),
    _DT_INT8: np.dtype('i1'),
    _DT_INT64: np.dtype('<i8'),
    _DT_BOOL: np.dtype('?'),
    _DT_UINT16: np.dtype('<u2'),
    _DT_HALF: np.dtype('<f2'),
    _DT_UINT32: np.dtype('<u4'),
    _DT_UINT64: np.dtype('<u8'),
}

_NUMPY_KIND_TO_DT = {np.dtype(d.str.lstrip('<=')): e
                     for e, d in _DT_TO_NUMPY.items()}


def _typed_values(msg: wire.TensorProtoCompat, dtype_enum: int) -> np.ndarray:
  """The typed repeated value field TensorFlow uses for this dtype."""
  if dtype_enum == _DT_FLOAT:
    return np.asarray(msg.float_val, np.float32)
  if dtype_enum == _DT_DOUBLE:
    return np.asarray(msg.double_val, np.float64)
  if dtype_enum in (_DT_INT32, _DT_UINT8, _DT_INT16, _DT_INT8, _DT_UINT16):
    return np.asarray(msg.int_val, np.int64).astype(_DT_TO_NUMPY[dtype_enum])
  if dtype_enum == _DT_INT64:
    return np.asarray(msg.int64_val, np.int64)
  if dtype_enum == _DT_BOOL:
    return np.asarray(msg.bool_val, bool)
  if dtype_enum == _DT_HALF:
    # Bit patterns widened to int32 on the wire.
    return np.asarray(msg.half_val, np.int64).astype(np.uint16).view('<f2')
  if dtype_enum == _DT_UINT32:
    return np.asarray(msg.uint32_val, np.uint32)
  if dtype_enum == _DT_UINT64:
    return np.asarray(msg.uint64_val, np.uint64)
  raise ValueError(f'Unsupported TensorProto dtype enum {dtype_enum}')


def tensor_proto_to_ndarray(msg: wire.TensorProtoCompat) -> np.ndarray:
  """A TensorProto as tf.make_ndarray reads it: `tensor_content` is the
  row-major little-endian array; otherwise the typed value field holds the
  elements, its last value repeated to fill the shape."""
  if msg.dtype == _DT_STRING:
    raise ValueError('DT_STRING tensors are not dense images')
  if msg.dtype not in _DT_TO_NUMPY:
    raise ValueError(f'Unsupported TensorProto dtype enum {msg.dtype}')
  dtype = _DT_TO_NUMPY[msg.dtype]
  if msg.tensor_shape.unknown_rank:
    raise ValueError('TensorProto with unknown rank')
  shape = tuple(int(d.size) for d in msg.tensor_shape.dim)
  size = math.prod(shape)
  if msg.tensor_content:
    arr = np.frombuffer(msg.tensor_content, dtype=dtype)
    if arr.size != size:
      raise ValueError(f'tensor_content holds {arr.size} elements, shape '
                       f'{shape} needs {size}')
    return arr.reshape(shape).copy()
  values = _typed_values(msg, msg.dtype)
  if values.size == 0 and size != 0:
    raise ValueError('TensorProto has neither tensor_content nor values')
  if values.size < size:
    values = np.pad(values, (0, size - values.size), mode='edge')
  return values[:size].astype(dtype, copy=False).reshape(shape)


def ndarray_to_tensor_proto(array: np.ndarray) -> wire.TensorProtoCompat:
  """An array as tf.make_tensor_proto encodes numpy input: the dtype enum,
  every dim of the shape and the row-major `tensor_content`."""
  array = np.ascontiguousarray(array)
  key = np.dtype(array.dtype.str.lstrip('<=|'))
  if key not in _NUMPY_KIND_TO_DT:
    raise ValueError(f'No TensorProto dtype for numpy dtype {array.dtype}')
  enum = _NUMPY_KIND_TO_DT[key]
  return wire.TensorProtoCompat(
      dtype=enum,
      tensor_shape=wire.TensorShapeProtoCompat(
          dim=[wire.TensorShapeProtoCompatDim(size=int(d))
               for d in array.shape]),
      # Little-endian on the wire (TensorFlow assumes little-endian hosts).
      tensor_content=array.astype(_DT_TO_NUMPY[enum], copy=False).tobytes())


# --- image-field sniffing ----------------------------------------------------

NDARRAY_FORMAT = 'ndarray'
TENSORPROTO_FORMAT = 'tensorproto'


def _try_ndarray(raw: bytes) -> Optional[np.ndarray]:
  try:
    nd = wire.NDArray.FromString(raw)
  except (wire.DecodeError, UnicodeDecodeError):
    return None
  if not nd.dtype:
    return None
  try:
    dtype = np.dtype(nd.dtype)
  except TypeError:
    return None
  shape = tuple(int(s) for s in nd.shape)
  if len(nd.data) != math.prod(shape) * dtype.itemsize:
    return None
  return np.frombuffer(nd.data, dtype=dtype).reshape(shape).copy()


def decode_image_bytes(raw: bytes) -> np.ndarray:
  """An image field's payload, NDArray or tensorflow.TensorProto, as an
  array. The formats are disjoint on the wire: a TensorProto's field 1 is
  a varint where NDArray declares a string, so it never sniffs as one."""
  arr = _try_ndarray(raw)
  if arr is not None:
    return arr
  try:
    tp = wire.TensorProtoCompat.FromString(raw)
  except (wire.DecodeError, UnicodeDecodeError) as e:
    raise ValueError(
        'Image field bytes parse as neither putting_dune NDArray nor '
        'tensorflow.TensorProto') from e
  return tensor_proto_to_ndarray(tp)


def ndarray_message(array: np.ndarray) -> wire.NDArray:
  array = np.ascontiguousarray(array)
  return wire.NDArray(dtype=array.dtype.str, shape=list(array.shape),
                      data=array.tobytes())


def encode_image_bytes(array: np.ndarray,
                       image_format: str = NDARRAY_FORMAT) -> bytes:
  if image_format == NDARRAY_FORMAT:
    return ndarray_message(array).SerializeToString()
  if image_format == TENSORPROTO_FORMAT:
    return ndarray_to_tensor_proto(array).SerializeToString()
  raise ValueError(f'Unknown image format {image_format!r}; expected '
                   f'{NDARRAY_FORMAT!r} or {TENSORPROTO_FORMAT!r}')
