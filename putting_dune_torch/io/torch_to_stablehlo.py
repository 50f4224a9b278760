"""A torch module at a fixed input shape as a StableHLO (VHLO) module.

`export(fn, input_shape, device)` traces `fn` (an `nn.Module`, or a
function of one tensor) with `torch.export` on a float32 input of
`input_shape`, applies the core-aten decompositions and maps each aten op
of the graph to VHLO ops through `_ATEN` (one entry an op); the weights
and buffers become `constant` ops, as the JAX package's exports hold
theirs. An aten op missing from the table raises `UnsupportedAtenOpError`
with its name. The ops emitted are the ones JAX lowers the same layers to
(their VHLO versions included), so `io/stablehlo.py` runs the result and
TensorFlow's `XlaCallModule` loads it.

The table covers what the port's exported models hold: the MLP policy
(`addmm`, `tanh`), the rate ensemble (`bmm`, batch norm in eval, `silu`,
`softplus`, `_softmax`, `mean`), the UNet and GlobalLocalUNet
(`convolution` forward and transposed, `native_layer_norm`, tanh `gelu`,
`max_pool2d_with_indices`, `cat`, `slice`) and the views between them;
and what their vector-Jacobian products reduce to (`export_vjp`):
`convolution_backward` (the input's gradient as a convolution),
`max_pool2d_with_indices_backward` (`select_and_scatter`), `silu_backward`,
`slice_scatter` (`pad`), `mm`, `sum`, `div`, `neg`, `full`. Float32 only.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from putting_dune_torch.io import mlir_bytecode as mb

Attr, Type, Value = mb.Attr, mb.Type, mb.Value

F32 = Type('vhlo', 'f32_v1')
I1 = Type('vhlo', 'bool_v1')
I32 = Type('vhlo', 'i32_v1')
I64 = Type('vhlo', 'i64_v1')
NONE = Attr('vhlo', 'type_v1', (Type('vhlo', 'none_v1'),))
UNKNOWN_LOC = Attr('builtin', 'unknown_loc')
_DEFAULT_ACCURACY = Attr('vhlo', 'result_accuracy_v1', (
    0, 0, 0, Attr('vhlo', 'result_accuracy_mode_v1', (0,))))
_PRECISION = Attr('vhlo', 'array_v1', (
    (Attr('vhlo', 'precision_v1', (0,)),) * 2,))
_NUMPY_OF = {'f32_v1': np.float32, 'bool_v1': np.bool_, 'i32_v1': np.int32,
             'i64_v1': np.int64}


class UnsupportedAtenOpError(NotImplementedError):
  """An aten op the export table does not map."""


def tensor_type(shape: Sequence[int], element: Type = F32) -> Type:
  return Type('vhlo', 'tensor_v1', (tuple(int(d) for d in shape), element))


def dense(array, element: Type = None) -> Attr:
  """A `tensor_v1` attribute holding `array`: row-major bytes, a bool
  array packed eight elements a byte, the first in the lowest bit (MLIR's
  i1 storage, which JAX writes and TF reads)."""
  array = np.asarray(array)
  if element is None:
    element = {np.dtype(np.float32): F32, np.dtype(np.bool_): I1,
               np.dtype(np.int32): I32, np.dtype(np.int64): I64}[array.dtype]
  values = np.ascontiguousarray(array.astype(_NUMPY_OF[element.kind]))
  data = (np.packbits(values.reshape(-1), bitorder='little').tobytes()
          if element == I1 else values.tobytes())
  return Attr('vhlo', 'tensor_v1', (tensor_type(array.shape, element), data))


def i64s(values) -> Attr:
  return dense(np.asarray(values, np.int64).reshape(-1), I64)


def i64(value: int) -> Attr:
  return Attr('vhlo', 'integer_v1', (I64, int(value) & ((1 << 64) - 1)))


class _T:
  """A traced tensor: its SSA value, shape and element type."""

  __slots__ = ('value', 'shape', 'element')

  def __init__(self, value: Value, shape, element: Type = F32):
    self.value, self.shape, self.element = value, tuple(shape), element


class _Builder:
  """Collects the ops of one block."""

  def __init__(self):
    self.ops: List[mb.Op] = []

  def op(self, name: str, operands: Sequence[_T], shapes, elements=None,
         props: Optional[dict] = None, regions=()) -> List[_T]:
    elements = elements or [F32] * len(shapes)
    results = [Value(tensor_type(s, e)) for s, e in zip(shapes, elements)]
    self.ops.append(mb.Op(
        name=f'vhlo.{name}', loc=UNKNOWN_LOC, props=props,
        operands=[t.value for t in operands], results=results,
        regions=list(regions), isolated=bool(regions)))
    return [_T(v, s, e) for v, s, e in zip(results, shapes, elements)]

  def one(self, name, operands, shape, element=F32, props=None,
          regions=()) -> _T:
    return self.op(name, operands, [shape], [element], props, regions)[0]

  # -- helpers ----------------------------------------------------------------

  def constant(self, array, element: Type = None) -> _T:
    attr = dense(array, element)
    shape, element = mb.tensor_type_of(attr.args[0])
    return self.one('constant_v1', [], shape, element, {'value': attr})

  def scalar(self, value: float, element: Type = F32) -> _T:
    return self.constant(np.asarray(value, _NUMPY_OF[element.kind]), element)

  def broadcast(self, x: _T, shape) -> _T:
    """numpy-style broadcast of x to `shape` as `broadcast_in_dim`."""
    shape = tuple(shape)
    if x.shape == shape:
      return x
    offset = len(shape) - len(x.shape)
    dims = list(range(offset, len(shape)))
    for d, s in zip(dims, x.shape):
      if s not in (1, shape[d]):
        raise ValueError(f'cannot broadcast {x.shape} to {shape}')
    # Size-1 dims that grow are mapped, as broadcast_in_dim allows.
    return self.one('broadcast_in_dim_v1', [x], shape, x.element,
                    {'broadcast_dimensions': i64s(dims)})

  def reshape(self, x: _T, shape) -> _T:
    shape = tuple(int(s) for s in shape)
    if x.shape == shape:
      return x
    return self.one('reshape_v1', [x], shape, x.element)

  def unary(self, name: str, x: _T) -> _T:
    props = ({'result_accuracy': _DEFAULT_ACCURACY}
             if name.endswith('_v2') else None)
    return self.one(name, [x], x.shape, x.element, props)

  def binary(self, name: str, a, b) -> _T:
    a, b = self._operands(a, b)
    return self.one(name, [a, b], a.shape, a.element)

  def _operands(self, *xs):
    tensors = [x for x in xs if isinstance(x, _T)]
    shape = np.broadcast_shapes(*[t.shape for t in tensors])
    element = tensors[0].element
    out = []
    for x in xs:
      if not isinstance(x, _T):
        x = self.scalar(float(x) if element == F32 else x, element)
      out.append(self.broadcast(x, shape))
    return out

  def compare(self, direction: int, a, b) -> _T:
    a, b = self._operands(a, b)
    return self.one('compare_v1', [a, b], a.shape, I1, {
        'compare_type': Attr('vhlo', 'comparison_type_v1', (1,)),
        'comparison_direction': Attr('vhlo', 'comparison_direction_v1',
                                     (direction,))})

  def reduce(self, kind: str, x: _T, dims: Sequence[int]) -> _T:
    dims = sorted(d % len(x.shape) for d in dims)
    init = {'add': 0.0, 'max': -np.inf}[kind]
    body = _reduce_body({'add': 'add_v1', 'max': 'maximum_v1'}[kind])
    shape = [s for i, s in enumerate(x.shape) if i not in dims]
    return self.one('reduce_v1', [x, self.scalar(init)], shape, F32,
                    {'dimensions': i64s(dims)}, [body])

  def dot(self, a: _T, b: _T, lhs_batch, rhs_batch, lhs_contract,
          rhs_contract) -> _T:
    lf = [d for d in range(len(a.shape)) if d not in lhs_batch + lhs_contract]
    rf = [d for d in range(len(b.shape)) if d not in rhs_batch + rhs_contract]
    shape = ([a.shape[d] for d in lhs_batch] + [a.shape[d] for d in lf]
             + [b.shape[d] for d in rf])
    return self.one('dot_general_v2', [a, b], shape, F32, {
        'accumulation_type': NONE, 'allow_imprecise_accumulation': NONE,
        'lhs_batching_dimensions': i64s(lhs_batch),
        'lhs_component_count': NONE,
        'lhs_contracting_dimensions': i64s(lhs_contract),
        'lhs_precision_type': NONE, 'num_primitive_operations': NONE,
        'precision_config': _PRECISION,
        'rhs_batching_dimensions': i64s(rhs_batch),
        'rhs_component_count': NONE,
        'rhs_contracting_dimensions': i64s(rhs_contract),
        'rhs_precision_type': NONE})


def _body(arg_types, op_name: str, element: Type = F32,
          props: Optional[dict] = None) -> mb.Region:
  """A region of one op of its two scalar block arguments."""
  a, b = (Value(t, UNKNOWN_LOC) for t in arg_types)
  out = Value(tensor_type((), element))
  ops = [mb.Op(name=f'vhlo.{op_name}', loc=UNKNOWN_LOC, operands=[a, b],
               results=[out], props=props),
         mb.Op(name='vhlo.return_v1', loc=UNKNOWN_LOC, operands=[out])]
  return mb.Region([mb.Block(args=[a, b], ops=ops)])


def _reduce_body(op_name: str) -> mb.Region:
  return _body([tensor_type(())] * 2, op_name)


# --- the aten table ----------------------------------------------------------

aten = torch.ops.aten
_ATEN: Dict[object, Callable] = {}


def _register(*ops):
  def wrap(fn):
    for op in ops:
      _ATEN[op] = fn
    return fn
  return wrap


_GE = 2  # comparison_direction_v1's GE


def _dim(d: int, rank: int) -> int:
  return d % rank if rank else 0


@_register(aten.view.default)
def _view(b, x, shape):
  shape = list(shape)
  if -1 in shape:
    known = math.prod(s for s in shape if s != -1)
    shape[shape.index(-1)] = math.prod(x.shape) // known
  return b.reshape(x, shape)


@_register(aten.permute.default)
def _permute(b, x, dims):
  dims = [_dim(d, len(x.shape)) for d in dims]
  if dims == sorted(dims):
    return x
  shape = [x.shape[d] for d in dims]
  return b.one('transpose_v1', [x], shape, x.element,
               {'permutation': i64s(dims)})


@_register(aten.expand.default)
def _expand(b, x, shape, implicit=False):
  del implicit
  offset = len(shape) - len(x.shape)
  shape = [x.shape[i - offset] if s == -1 else s for i, s in enumerate(shape)]
  return b.broadcast(x, shape)


@_register(aten.unsqueeze.default)
def _unsqueeze(b, x, dim):
  shape = list(x.shape)
  shape.insert(_dim(dim, len(shape) + 1), 1)
  return b.reshape(x, shape)


@_register(aten.slice.Tensor)
def _slice_op(b, x, dim=0, start=None, end=None, step=1):
  dim = _dim(dim, len(x.shape))
  size = x.shape[dim]
  start, end, _ = slice(start, end, step).indices(size)
  end = max(end, start)
  if (start, end, step) == (0, size, 1):
    return x
  starts = [0] * len(x.shape)
  limits = list(x.shape)
  strides = [1] * len(x.shape)
  starts[dim], limits[dim], strides[dim] = start, end, step
  shape = list(x.shape)
  shape[dim] = len(range(start, end, step))
  return b.one('slice_v1', [x], shape, x.element, {
      'limit_indices': i64s(limits), 'start_indices': i64s(starts),
      'strides': i64s(strides)})


@_register(aten.cat.default)
def _cat(b, tensors, dim=0):
  tensors = [t for t in tensors if math.prod(t.shape)]
  dim = _dim(dim, len(tensors[0].shape))
  shape = list(tensors[0].shape)
  shape[dim] = sum(t.shape[dim] for t in tensors)
  return b.one('concatenate_v1', tensors, shape, tensors[0].element,
               {'dimension': i64(dim)})


@_register(aten.bmm.default)
def _bmm(b, x, y):
  return b.dot(x, y, [0], [0], [2], [1])


@_register(aten.mm.default)
def _mm(b, x, y):
  return b.dot(x, y, [], [], [1], [0])


@_register(aten.addmm.default)
def _addmm(b, bias, x, y, beta=1, alpha=1):
  out = b.dot(x, y, [], [], [1], [0])
  if alpha != 1:
    out = b.binary('multiply_v1', out, alpha)
  if beta != 1:
    bias = b.binary('multiply_v1', bias, beta)
  return b.binary('add_v1', out, bias)


@_register(aten.add.Tensor)
def _add(b, x, y, alpha=1):
  if alpha != 1:
    y = b.binary('multiply_v1', y, alpha)
  if not isinstance(x, _T):
    x, y = y, x
  return b.binary('add_v1', x, y)


@_register(aten.sub.Tensor)
def _sub(b, x, y, alpha=1):
  if alpha != 1:
    y = b.binary('multiply_v1', y, alpha)
  if not isinstance(x, _T):
    x = b.scalar(float(x))
  return b.binary('subtract_v1', x, y)


def _commuting(name):
  def fn(b, x, y):
    if not isinstance(x, _T):
      x, y = y, x
    return b.binary(name, x, y)
  return fn


_register(aten.mul.Tensor)(_commuting('multiply_v1'))


def _unary(name):
  return lambda b, x: b.unary(name, x)


for _op, _name in ((aten.rsqrt.default, 'rsqrt_v2'),
                   (aten.tanh.default, 'tanh_v2'),
                   (aten.sigmoid.default, 'logistic_v2'),
                   (aten.exp.default, 'exponential_v2'),
                   (aten.log1p.default, 'log_plus_one_v2')):
  _ATEN[_op] = _unary(_name)


@_register(aten.alias.default, aten.clone.default)
def _alias(b, x, memory_format=None):
  del b, memory_format
  return x


@_register(aten.full.default)
def _full(b, size, fill_value, dtype=None, layout=None, device=None,
          pin_memory=None):
  del layout, device, pin_memory
  if dtype not in (None, torch.float32):
    raise UnsupportedAtenOpError(f'aten.full of {dtype}')
  return b.broadcast(b.scalar(float(fill_value)), list(size))


@_register(aten.sum.dim_IntList)
def _sum(b, x, dims, keepdim=False, dtype=None):
  del dtype
  dims = list(range(len(x.shape))) if not dims else list(dims)
  return _keep(b, b.reduce('add', x, dims), x, dims, keepdim)


@_register(aten.div.Tensor, aten.div.Scalar)
def _div(b, x, y):
  if not isinstance(x, _T):
    x = b.scalar(float(x))
  return b.binary('divide_v1', x, y)


_register(aten.neg.default)(lambda b, x: b.unary('negate_v1', x))


@_register(aten.silu_backward.default)
def _silu_backward(b, grad, x):
  """grad sigmoid(x) (1 + x (1 - sigmoid(x)))."""
  s = b.unary('logistic_v2', x)
  inner = b.binary('add_v1', b.binary('multiply_v1', x, b.binary(
      'subtract_v1', b.scalar(1.0), s)), 1.0)
  return b.binary('multiply_v1', grad, b.binary('multiply_v1', s, inner))


@_register(aten.slice_scatter.default)
def _slice_scatter(b, x, src, dim=0, start=None, end=None, step=1):
  """x with src written over x[start:end:step] along dim: src padded out
  to x's shape (as JAX transposes a slice), then selected where ones
  padded the same way are 1 (a mask made of ops, so that no constant of
  x's size is written)."""
  dim = _dim(dim, len(x.shape))
  start, end, step = slice(start, end, step).indices(x.shape[dim])
  low, high, interior = ([0] * len(x.shape) for _ in range(3))
  low[dim] = start
  interior[dim] = step - 1
  high[dim] = x.shape[dim] - (start + (src.shape[dim] - 1) * step + 1)
  pads = {'edge_padding_high': i64s(high), 'edge_padding_low': i64s(low),
          'interior_padding': i64s(interior)}
  padded = b.one('pad_v1', [src, b.scalar(0.0)], x.shape, F32, pads)
  ones = b.broadcast(b.scalar(1.0), src.shape)
  mask = b.one('pad_v1', [ones, b.scalar(0.0)], x.shape, F32, pads)
  where = b.compare(3, mask, 0.0)  # GT
  return b.one('select_v1', [where, padded, x], x.shape, F32)


@_register(aten.gt.Scalar)
def _gt(b, x, y):
  return b.compare(3, x, y)  # GT


@_register(aten.where.self)
def _where(b, cond, x, y):
  shape = np.broadcast_shapes(*[t.shape for t in (cond, x, y)
                                if isinstance(t, _T)])
  cond = b.broadcast(cond, shape)
  x, y = b._operands(x, y)  # pylint: disable=protected-access
  x, y = b.broadcast(x, shape), b.broadcast(y, shape)
  return b.one('select_v1', [cond, x, y], shape, x.element)


def _keep(b, out, x, dims, keepdim):
  if not keepdim:
    return out
  dims = {_dim(d, len(x.shape)) for d in dims}
  return b.reshape(out, [1 if i in dims else s for i, s in enumerate(x.shape)])


@_register(aten.mean.dim)
def _mean(b, x, dims, keepdim=False, dtype=None):
  del dtype
  dims = list(range(len(x.shape))) if not dims else list(dims)
  count = math.prod(x.shape[_dim(d, len(x.shape))] for d in dims)
  out = b.binary('divide_v1', b.reduce('add', x, dims), float(count))
  return _keep(b, out, x, dims, keepdim)


@_register(aten._softmax.default)
def _softmax(b, x, dim, half_to_float=False):
  del half_to_float
  dim = _dim(dim, len(x.shape))
  top = _keep(b, b.reduce('max', x, [dim]), x, [dim], True)
  e = b.unary('exponential_v2', b.binary('subtract_v1', x, top))
  total = _keep(b, b.reduce('add', e, [dim]), x, [dim], True)
  return b.binary('divide_v1', e, total)


@_register(aten.gelu.default)
def _gelu(b, x, approximate='none'):
  if approximate != 'tanh':
    raise UnsupportedAtenOpError(
        f"aten.gelu with approximate={approximate!r} (only 'tanh')")
  # 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), as jax.nn.gelu.
  cube = b.binary('multiply_v1', b.binary('multiply_v1', x, x), x)
  inner = b.binary('add_v1', x, b.binary('multiply_v1', cube, 0.044715))
  inner = b.binary('multiply_v1', inner, math.sqrt(2.0 / math.pi))
  t = b.binary('add_v1', b.unary('tanh_v2', inner), 1.0)
  return b.binary('multiply_v1', b.binary('multiply_v1', x, 0.5), t)


@_register(aten.native_layer_norm.default)
def _layer_norm(b, x, normalized_shape, weight, bias, eps):
  rank = len(x.shape)
  dims = list(range(rank - len(normalized_shape), rank))
  count = float(math.prod(normalized_shape))
  mean = _keep(b, b.binary('divide_v1', b.reduce('add', x, dims), count),
               x, dims, True)
  centred = b.binary('subtract_v1', x, mean)
  var = _keep(b, b.binary('divide_v1', b.reduce(
      'add', b.binary('multiply_v1', centred, centred), dims), count),
              x, dims, True)
  rstd = b.unary('rsqrt_v2', b.binary('add_v1', var, float(eps)))
  y = b.binary('multiply_v1', centred, rstd)
  if weight is not None:
    y = b.binary('multiply_v1', y, weight)
  if bias is not None:
    y = b.binary('add_v1', y, bias)
  return (y, mean, rstd)


@_register(aten.convolution.default)
def _convolution(b, x, w, bias, stride, padding, dilation, transposed,
                 output_padding, groups):
  n = len(x.shape) - 2
  if transposed:
    if groups != 1:
      raise UnsupportedAtenOpError('a grouped transposed aten.convolution')
    # (in, out, k...) reversed over k and transposed -> the forward kernel
    # (out, in, k...) over the input dilated by the stride, as JAX lowers
    # it (the weights stay stored once; the interpreter folds both ops).
    spatial = list(range(2, 2 + n))
    w = b.one('reverse_v1', [w], w.shape, F32,
              {'dimensions': i64s(spatial)})
    w = b.one('transpose_v1', [w], [w.shape[1], w.shape[0], *w.shape[2:]],
              F32, {'permutation': i64s([1, 0] + spatial)})
    k = w.shape[2:]
    lhs_dilation = list(stride)
    pads = []
    for j in range(n):
      edge = dilation[j] * (k[j] - 1) - padding[j]
      pads += [edge, edge + output_padding[j]]
    strides = [1] * n
  else:
    lhs_dilation = [1] * n
    pads = [p for p in padding for _ in range(2)]
    strides = list(stride)
    k = w.shape[2:]
  spatial = []
  for j in range(n):
    size = (x.shape[2 + j] - 1) * lhs_dilation[j] + 1 + pads[2 * j] + \
        pads[2 * j + 1]
    span = dilation[j] * (k[j] - 1) + 1
    spatial.append((size - span) // strides[j] + 1)
  shape = [x.shape[0], w.shape[0], *spatial]
  out = b.one('convolution_v1', [x, w], shape, F32, {
      'batch_group_count': i64(1), 'feature_group_count': i64(groups),
      'input_batch_dimension': i64(0), 'input_feature_dimension': i64(1),
      'input_spatial_dimensions': i64s(range(2, 2 + n)),
      'kernel_input_feature_dimension': i64(1),
      'kernel_output_feature_dimension': i64(0),
      'kernel_spatial_dimensions': i64s(range(2, 2 + n)),
      'lhs_dilation': i64s(lhs_dilation),
      'output_batch_dimension': i64(0), 'output_feature_dimension': i64(1),
      'output_spatial_dimensions': i64s(range(2, 2 + n)),
      'padding': dense(np.asarray(pads, np.int64).reshape(n, 2), I64),
      'precision_config': _PRECISION, 'rhs_dilation': i64s(dilation),
      'window_reversal': dense(np.zeros(n, bool), I1),
      'window_strides': i64s(strides)})
  if bias is not None:
    bias = b.one('broadcast_in_dim_v1', [bias], shape, F32,
                 {'broadcast_dimensions': i64s([1])})
    out = b.binary('add_v1', out, bias)
  return out


@_register(aten.convolution_backward.default)
def _convolution_backward(b, grad, x, w, bias_sizes, stride, padding,
                          dilation, transposed, output_padding, groups,
                          output_mask):
  """The input's gradient: the transposed convolution of a forward one,
  the forward convolution of a transposed one. The weights are constants,
  so their gradients are never asked for."""
  del bias_sizes, output_padding
  if not output_mask[0]:
    return (None, None, None)
  n = len(x.shape) - 2
  if transposed:
    # A transposed convolution's kernel (in, out, k...) is a forward
    # kernel from its output channels back to its input channels.
    out = _convolution(b, grad, w, None, stride, padding, dilation, False,
                       [0] * n, groups)
  else:
    k = w.shape[2:]
    extra = [x.shape[2 + j] - ((grad.shape[2 + j] - 1) * stride[j]
                               - 2 * padding[j] + dilation[j] * (k[j] - 1)
                               + 1) for j in range(n)]
    out = _convolution(b, grad, w, None, stride, padding, dilation, True,
                       extra, groups)
  if tuple(out.shape) != tuple(x.shape):
    raise UnsupportedAtenOpError(
        f'aten.convolution_backward gave {out.shape}, not {x.shape}')
  return (out, None, None)


@_register(aten.max_pool2d_with_indices.default)
def _max_pool(b, x, kernel, stride=(), padding=(0, 0), dilation=(1, 1),
              ceil_mode=False):
  if ceil_mode:
    raise UnsupportedAtenOpError('aten.max_pool2d_with_indices, ceil_mode')
  stride = list(stride) or list(kernel)
  rank = len(x.shape)
  window = [1] * (rank - 2) + list(kernel)
  strides = [1] * (rank - 2) + stride
  dil = [1] * (rank - 2) + list(dilation)
  pads = [0, 0] * (rank - 2) + [p for p in padding for _ in range(2)]
  shape = list(x.shape[:rank - 2])
  for j in range(2):
    size = x.shape[rank - 2 + j] + 2 * padding[j]
    shape.append((size - dil[rank - 2 + j] * (kernel[j] - 1) - 1)
                 // stride[j] + 1)
  out = b.one('reduce_window_v1', [x, b.scalar(-np.inf)], shape, F32, {
      'base_dilations': i64s([1] * rank),
      'padding': dense(np.asarray(pads, np.int64).reshape(rank, 2), I64),
      'window_dilations': i64s(dil), 'window_dimensions': i64s(window),
      'window_strides': i64s(strides)}, [_reduce_body('maximum_v1')])
  return (out, _POOL_INDICES)


class _PoolIndices:
  """What stands for max pooling's indices: its backward (below) selects
  from the pooled input again, as JAX's VJP does, and reads nothing
  else of them."""


_POOL_INDICES = _PoolIndices()


@_register(aten.max_pool2d_with_indices_backward.default)
def _max_pool_backward(b, grad, x, kernel, stride=(), padding=(0, 0),
                       dilation=(1, 1), ceil_mode=False, indices=None):
  """The gradient reaches the first largest element of each window
  (torch's index, and `select_and_scatter` with GE, as JAX lowers it)."""
  del indices
  stride = list(stride) or list(kernel)
  if ceil_mode or any(padding) or any(d != 1 for d in dilation):
    raise UnsupportedAtenOpError(
        'aten.max_pool2d_with_indices_backward with padding, dilation or '
        'ceil_mode')
  rank = len(x.shape)
  select = _body([tensor_type(())] * 2, 'compare_v1', I1, {
      'compare_type': Attr('vhlo', 'comparison_type_v1', (1,)),
      'comparison_direction': Attr('vhlo', 'comparison_direction_v1',
                                   (_GE,))})
  scatter = _reduce_body('add_v1')
  return b.one('select_and_scatter_v1', [x, grad, b.scalar(0.0)], x.shape,
               F32, {
                   'padding': dense(np.zeros((rank, 2), np.int64), I64),
                   'window_dimensions': i64s([1] * (rank - 2) + list(kernel)),
                   'window_strides': i64s([1] * (rank - 2) + stride)},
               [select, scatter])


@_register(operator.getitem)
def _getitem(b, values, index):
  del b
  value = values[index]
  if value is None:
    raise UnsupportedAtenOpError('a gradient of a weight (weights are '
                                 'constants of the export)')
  return value


# --- the export --------------------------------------------------------------


class _Wrap(torch.nn.Module):

  def __init__(self, fn):
    super().__init__()
    self.fn = fn

  def forward(self, x):
    return self.fn(x)


def export(fn, input_shape: Sequence[int], device
           ) -> Tuple[mb.Module, list, bool]:
  """(module, output shapes, whether `fn` returns a tuple) of `fn` traced
  at a float32 input of `input_shape` on `device`. `main` takes the
  platform index first (an i32 scalar that JAX marks
  `jax.global_constant`), as a JAX export for several platforms does: the
  module is the same on each."""
  module = fn if isinstance(fn, torch.nn.Module) else _Wrap(fn)
  return _export(module, [tuple(input_shape)], device)


class _Vjp(torch.nn.Module):
  """(x, cotangents...) -> the cotangent of x: autograd's vector-Jacobian
  product of fn at x."""

  def __init__(self, fn):
    super().__init__()
    self.fn = fn

  def forward(self, x, *cotangents):
    with torch.enable_grad():
      x = x.detach().requires_grad_(True)
      out = self.fn(x)
      outs = out if isinstance(out, (tuple, list)) else (out,)
      return torch.autograd.grad(outs, x, cotangents)[0]


def export_vjp(fn, input_shape: Sequence[int], out_shapes, device
               ) -> mb.Module:
  """The module of fn's vector-Jacobian product at `input_shape`: `main`
  takes the platform index, x and one cotangent an output (`out_shapes`)
  and returns the cotangent of x, as the VJP module of a JAX export with
  gradients does. Autograd's graph of the product is recorded by
  `make_fx` (torch.export's tracer, which keeps the backward ops whole;
  `torch.export` of `autograd.grad` itself fails in torch 2.13), then
  exported and lowered as `export` lowers a forward function."""
  from torch.fx.experimental import proxy_tensor

  module = fn if isinstance(fn, torch.nn.Module) else _Wrap(fn)
  shapes = [tuple(input_shape)] + [tuple(s) for s in out_shapes]
  examples = [torch.zeros(s, dtype=torch.float32, device=device)
              for s in shapes]
  graph = proxy_tensor.make_fx(_Vjp(module))(*examples)
  return _export(graph, shapes, device)[0]


def _export(module: torch.nn.Module, input_shapes, device
            ) -> Tuple[mb.Module, list, bool]:
  examples = tuple(torch.zeros(s, dtype=torch.float32, device=device)
                   for s in input_shapes)
  with torch.no_grad():
    program = torch.export.export(module, examples).run_decompositions()
  graph_signature = program.graph_signature
  state = dict(program.state_dict)
  state.update(getattr(program, 'constants', {}) or {})
  lifted = {}
  for spec in graph_signature.input_specs:
    if spec.kind.name != 'USER_INPUT':
      lifted[spec.arg.name] = state[spec.target]

  b = _Builder()
  args = [Value(tensor_type((), I32), UNKNOWN_LOC)]
  env: Dict[str, object] = {}
  outputs = None
  user_shapes = iter(input_shapes)
  for node in program.graph.nodes:
    if node.op == 'placeholder':
      if node.name in lifted:
        value = lifted[node.name].detach().to('cpu')
        if value.dtype not in (torch.float32, torch.bool):
          raise UnsupportedAtenOpError(
              f'a {value.dtype} weight or buffer ({node.name})')
        env[node.name] = b.constant(value.numpy())
      else:
        shape = next(user_shapes)
        v = Value(tensor_type(shape), UNKNOWN_LOC)
        args.append(v)
        env[node.name] = _T(v, shape)
    elif node.op == 'call_function':
      handler = _ATEN.get(node.target)
      if handler is None:
        raise UnsupportedAtenOpError(
            f'{node.target} is not in the export table; see ROADMAP '
            'queue 1')
      resolve = lambda a: (env[a.name] if isinstance(a, torch.fx.Node)
                           else [resolve(x) for x in a]
                           if isinstance(a, (list, tuple)) else a)
      env[node.name] = handler(b, *[resolve(a) for a in node.args],
                               **{k: resolve(v)
                                  for k, v in node.kwargs.items()})
    elif node.op == 'output':
      outputs = [env[a.name] for a in node.args[0]]
  out_spec = program.module_call_graph[0].signature.out_spec
  is_tuple = out_spec.type in (tuple, list)
  flat = outputs
  for t in flat:
    if not isinstance(t, _T):
      raise UnsupportedAtenOpError('an output that is not a tensor')
  b.ops.append(mb.Op(name='vhlo.return_v1', loc=UNKNOWN_LOC,
                     operands=[t.value for t in flat]))
  b.ops = _live(b.ops)
  return _module(args, b.ops, flat), [t.shape for t in flat], is_tuple


def _live(ops: List[mb.Op]) -> List[mb.Op]:
  """The ops whose results are used, and the return: a value an op
  computes but no output needs (a weight gradient's operands, the indices
  of a max pool) is not written."""
  used = set()
  kept = []
  for op in reversed(ops):
    if op.name == 'vhlo.return_v1' or any(id(v) in used for v in op.results):
      kept.append(op)
      used.update(id(v) for v in op.operands)
  return kept[::-1]


def _string(s: str) -> Attr:
  return Attr('vhlo', 'string_v1', (s,))


def _module(args, ops, outputs) -> mb.Module:
  arg_attrs = [Attr('vhlo', 'dict_v1', ((),)) for _ in args]
  arg_attrs[0] = Attr('vhlo', 'dict_v1', ((
      (_string('jax.global_constant'), _string('_platform_index')),),))
  res_attrs = [Attr('vhlo', 'dict_v1', ((
      (_string('jax.result_info'),
       _string('result' if len(outputs) == 1 else f'result[{i}]')),),))
               for i in range(len(outputs))]
  func_type = Type('vhlo', 'func_v1', (tuple(a.type for a in args),
                                       tuple(t.value.type for t in outputs)))
  func = mb.Op(
      name='vhlo.func_v1', loc=UNKNOWN_LOC, isolated=True,
      props={'arg_attrs': Attr('vhlo', 'array_v1', (tuple(arg_attrs),)),
             'function_type': Attr('vhlo', 'type_v1', (func_type,)),
             'res_attrs': Attr('vhlo', 'array_v1', (tuple(res_attrs),)),
             'sym_name': _string('main'),
             'sym_visibility': _string('public')},
      regions=[mb.Region([mb.Block(args=list(args), ops=ops)])])
  i1 = Type('builtin', 'integer', (1 << 2,))
  i32 = Type('builtin', 'integer', (32 << 2,))
  entries = [
      # True, as in JAX's exports for several platforms: TF then refines
      # the module, setting the platform index.
      ('jax.uses_shape_polymorphism', Attr('builtin', 'integer', (i1, 1))),
      ('mhlo.num_partitions', Attr('builtin', 'integer', (i32, 1))),
      ('mhlo.num_replicas', Attr('builtin', 'integer', (i32, 1))),
  ]
  attrs = Attr('builtin', 'dictionary', (tuple(
      (Attr('builtin', 'string', (k,)), v) for k, v in sorted(entries)),))
  root = mb.Op(
      name='builtin.module', loc=UNKNOWN_LOC, attrs=attrs, isolated=True,
      props={'sym_name': Attr('builtin', 'string', ('jit_fn',)),
             'sym_visibility': None},
      regions=[mb.Region([mb.Block(ops=[func])])])
  return mb.Module(mb.BYTECODE_VERSION, mb.PRODUCER, root)
