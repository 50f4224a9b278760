"""TensorFlow ops as torch functions: the op table of the SavedModel loader.

`OPS` maps a TF op type to a function `(ctx, node, inputs) -> outputs` that
computes what TF computes: TF's broadcasting and dtypes, shape operands as
int32 or int64 tensors, `data_format`, and TF's SAME split (the odd
element of padding at the end). `ctx` is the loader (`io/tf_export.py`):
its `device`, `call_function(name, args)` and `function_def(name)`, through
which func-valued attrs resolve in the graph's function library.

It holds the ops of graphs that jax2tf's pre-native path wrote in both of
its modes, and what TF's own tracing adds around them:

  * elementwise and shape ops: `AddV2`, `Sub`, `Mul`, `RealDiv`, `Neg`,
    `Abs`, `Maximum`, `Minimum`, `Square`, `Rsqrt`, `Sqrt`, `Tanh`, `Exp`,
    `Log1p`, `Sigmoid`, `Relu`, `Erf`, `NotEqual`, `Equal`, `Less`,
    `Greater`, `LogicalOr`, `IsNan`, `SelectV2`, `Cast`, `Reshape`,
    `BroadcastTo`, `Squeeze`, `ExpandDims`, `Transpose`, `ReverseV2`,
    `ConcatV2`, `Slice`, `StridedSlice`, `Pack`, `Sum`, `Max`, `Mean`,
    `Shape`, `Fill`, `Range`, `Identity`, `IdentityN`, `StopGradient`,
    `PreventGradient`, `NoOp`;
  * the XLA form (`enable_xla=True`): `XlaConvV2` / `XlaConv` (an
    lhs-dilated one, a transposed convolution, as `conv_transpose`),
    `XlaDotV2` / `XlaDot`, `XlaReduceWindow`, `XlaPad`, `XlaGather`,
    `XlaDynamicSlice`. The convolution, product, window and pad run through
    the helpers of `io/stablehlo.py`, so both interpreters share them. A
    reducer function that is one `Maximum`, `Minimum` or `AddV2` of its
    two arguments reduces as that monoid; any other is called through the
    function library over the unfolded windows, one window element at a
    time. As in XLA, a window's padding takes no part in its reduction;
  * the plain form (`enable_xla=False`): `Conv2D` (SAME, VALID and
    EXPLICIT padding, dilations, NHWC and NCHW), `Conv2DBackpropInput`,
    `BiasAdd`, `MaxPool`, `MatMul`, `BatchMatMulV2`, `Einsum`, `Pad`,
    `PadV2`, `GatherV2`.

Integer tensors of a few elements (shapes, axes, paddings) live on the
host, as TF keeps int32 in host memory: reading them as ints needs no
device sync. Binary ops move such a host operand to the other's device.
`StopGradient` and `PreventGradient` detach, so torch autograd
differentiates the rest of a graph as TF's GradientTape does. Every
function runs in full float32 under `stablehlo.full_float32()`, which the
loader holds around a call. An op outside the table, or an attr value an
op does not take, raises `UnsupportedGraphError` naming it; the loader adds
the node and the file.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from putting_dune_torch.io import stablehlo
from putting_dune_torch.proto import tf_wire as tw


class UnsupportedGraphError(NotImplementedError):
  """A SavedModel graph the loader does not interpret."""


# tensorflow.DataType -> torch.
DTYPES = {1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8,
          5: torch.int16, 6: torch.int8, 9: torch.int64, 10: torch.bool,
          14: torch.bfloat16, 19: torch.float16}
# Integer tensors up to this many elements stay on the host.
HOST_INT_ELEMENTS = 64


def dtype_of(value: int) -> torch.dtype:
  if value not in DTYPES:
    raise UnsupportedGraphError(f'TF dtype {value}')
  return DTYPES[value]


def on_host(dtype: torch.dtype, numel: int) -> bool:
  return (not dtype.is_floating_point and dtype != torch.bool
          and numel <= HOST_INT_ELEMENTS)


def _attr(node: tw.NodeDef, name: str):
  return node.attr.get(name)


def _attr_int(node, name, default=0) -> int:
  value = _attr(node, name)
  return default if value is None else int(value.i)


def _attr_ints(node, name) -> List[int]:
  value = _attr(node, name)
  return [] if value is None else [int(v) for v in value.list.i]


def _attr_str(node, name, default='') -> str:
  value = _attr(node, name)
  return default if value is None else value.s.decode()


def _attr_bool(node, name) -> bool:
  value = _attr(node, name)
  return bool(value is not None and value.b)


def ints(t: torch.Tensor) -> List[int]:
  """A shape operand's values (a host copy: no sync for host tensors)."""
  return [int(v) for v in t.reshape(-1).tolist()]


def _int(t: torch.Tensor) -> int:
  return int(t.reshape(()).item())


def same_device(*tensors) -> List[torch.Tensor]:
  """The operands on one device: a host one joins a device one."""
  devices = {t.device for t in tensors}
  if len(devices) == 1:
    return list(tensors)
  target = next(t.device for t in tensors if t.device.type != 'cpu')
  return [t.to(target) for t in tensors]


def _one(fn: Callable) -> Callable:
  return lambda ctx, node, inputs: [fn(*inputs)]


def _binary(fn: Callable) -> Callable:

  def run(ctx, node, inputs):
    a, b = same_device(*inputs)
    return [fn(a, b)]

  return run


def _real_div(a, b):
  if a.is_floating_point():
    return torch.div(a, b)
  raise UnsupportedGraphError(f'RealDiv of {a.dtype}')


# --- shape ops ---------------------------------------------------------------


def _reshape(ctx, node, inputs):
  x, shape = inputs
  return [x.reshape(ints(shape))]


def _broadcast_to(ctx, node, inputs):
  x, shape = inputs
  return [x.expand(ints(shape))]


def _squeeze(ctx, node, inputs):
  (x,) = inputs
  dims = _attr_ints(node, 'squeeze_dims')
  if not dims:
    return [x.reshape([d for d in x.shape if d != 1])]
  dims = {d % x.dim() for d in dims}
  return [x.reshape([s for d, s in enumerate(x.shape) if d not in dims])]


def _expand_dims(ctx, node, inputs):
  x, dim = inputs
  d = _int(dim)
  return [x.unsqueeze(d if d >= 0 else d + x.dim() + 1)]


def _transpose(ctx, node, inputs):
  x, perm = inputs
  return [x.permute(ints(perm))]


def _reverse(ctx, node, inputs):
  x, axis = inputs
  return [torch.flip(x, [d % x.dim() for d in ints(axis)])]


def _concat(ctx, node, inputs):
  *values, axis = inputs
  return [torch.cat(same_device(*values), dim=_int(axis))]


def _pack(ctx, node, inputs):
  axis = _attr_int(node, 'axis')
  rank = inputs[0].dim() + 1
  return [torch.stack(same_device(*inputs), dim=axis % rank)]


def _slice(ctx, node, inputs):
  x, begin, size = inputs
  index = tuple(slice(b, None if s == -1 else b + s)
                for b, s in zip(ints(begin), ints(size)))
  return [x[index]]


def strided_slice(x, begin, end, strides, begin_mask=0, end_mask=0,
                  ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0):
  """TF's StridedSlice on python ints: masks, an ellipsis, new axes,
  shrunk axes and negative strides."""
  n = len(begin)
  items, reversed_dims = [], []
  in_dim = out_dim = 0
  for i in range(n):
    if ellipsis_mask >> i & 1:
      after = sum(1 for j in range(i + 1, n) if not new_axis_mask >> j & 1)
      span = x.dim() - in_dim - after
      items += [slice(None)] * span
      in_dim += span
      out_dim += span
      continue
    if new_axis_mask >> i & 1:
      items.append(None)
      out_dim += 1
      continue
    size = x.shape[in_dim]
    b, e, s = begin[i], end[i], strides[i]
    if s == 0:
      raise UnsupportedGraphError('StridedSlice with a stride of 0')
    if shrink_axis_mask >> i & 1:
      items.append(b + size if b < 0 else b)
      in_dim += 1
      continue
    lo, hi, step = slice(None if begin_mask >> i & 1 else b,
                         None if end_mask >> i & 1 else e, s).indices(size)
    if step > 0:
      items.append(slice(lo, hi, step))
    else:
      items.append(slice(None))
      reversed_dims.append((out_dim, list(range(lo, hi, step))))
    in_dim += 1
    out_dim += 1
  y = x[tuple(items)]
  for d, index in reversed_dims:
    y = y.index_select(d, torch.tensor(index, dtype=torch.long,
                                       device=y.device))
  return y


def _strided_slice(ctx, node, inputs):
  x, begin, end, strides = inputs
  return [strided_slice(
      x, ints(begin), ints(end), ints(strides),
      *(_attr_int(node, k) for k in ('begin_mask', 'end_mask',
                                     'ellipsis_mask', 'new_axis_mask',
                                     'shrink_axis_mask')))]


def _reduction(kind: str) -> Callable:
  fns = {'sum': torch.sum, 'max': torch.amax, 'mean': torch.mean}

  def run(ctx, node, inputs):
    x, axes = inputs
    dims = tuple(sorted({d % x.dim() for d in ints(axes)})) if x.dim() else ()
    keep = _attr_bool(node, 'keep_dims')
    if not dims:
      return [x]
    return [fns[kind](x, dim=dims, keepdim=keep)]

  return run


def _shape(ctx, node, inputs):
  (x,) = inputs
  out_type = _attr(node, 'out_type')
  dtype = dtype_of(out_type.type) if out_type is not None else torch.int32
  return [torch.tensor(list(x.shape), dtype=dtype)]


def _fill(ctx, node, inputs):
  dims, value = inputs
  return [value.reshape(()).expand(ints(dims))]


def _range(ctx, node, inputs):
  start, limit, delta = inputs
  dtype = start.dtype
  values = [t.reshape(()).item() for t in (start, limit, delta)]
  return [torch.arange(*values, dtype=dtype, device=start.device)]


def _cast(ctx, node, inputs):
  (x,) = inputs
  return [x.to(dtype_of(node.attr['DstT'].type))]


def _select(ctx, node, inputs):
  return [torch.where(*same_device(*inputs))]


# --- the XLA form ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dimension_numbers(message, data: bytes):
  """A serialized `xla_data.proto` attr, parsed once per distinct value."""
  return message.FromString(data)


def _preferred(node, y):
  value = _attr(node, 'preferred_element_type')
  if value is not None and value.type:
    y = y.to(dtype_of(value.type))
  return y


def _xla_conv(ctx, node, inputs):
  x, w, strides, padding, lhs_dil, rhs_dil, groups = inputs
  numbers = _dimension_numbers(tw.ConvolutionDimensionNumbers,
                               node.attr['dimension_numbers'].s)
  run = stablehlo.convolution(
      input_batch=numbers.input_batch_dimension,
      input_feature=numbers.input_feature_dimension,
      input_spatial=list(numbers.input_spatial_dimensions),
      kernel_input=numbers.kernel_input_feature_dimension,
      kernel_output=numbers.kernel_output_feature_dimension,
      kernel_spatial=list(numbers.kernel_spatial_dimensions),
      output_batch=numbers.output_batch_dimension,
      output_feature=numbers.output_feature_dimension,
      output_spatial=list(numbers.output_spatial_dimensions),
      strides=ints(strides), padding=ints(padding),
      lhs_dilation=ints(lhs_dil), rhs_dilation=ints(rhs_dil),
      feature_group_count=_int(groups),
      batch_group_count=_attr_int(node, 'batch_group_count', 1),
      kernel_shape=tuple(w.shape))
  return [_preferred(node, run(*same_device(x, w)))]


def _xla_dot(ctx, node, inputs):
  a, b = same_device(*inputs)
  numbers = _dimension_numbers(tw.DotDimensionNumbers,
                               node.attr['dimension_numbers'].s)
  run = stablehlo.dot_general(
      numbers.lhs_batch_dimensions, numbers.rhs_batch_dimensions,
      numbers.lhs_contracting_dimensions, numbers.rhs_contracting_dimensions)
  return [_preferred(node, run(a, b))]


_MONOIDS = {'Maximum': 'max', 'Minimum': 'min', 'AddV2': 'add', 'Add': 'add'}


def _source(fdef: tw.FunctionDef, nodes: Dict[str, tw.NodeDef], ref: str):
  """The node a reference names (through Identity), or the argument's
  name for a function argument."""
  while True:
    name = ref.split(':')[0]
    node = nodes.get(name)
    if node is None or node.op != 'Identity':
      return node if node is not None else name
    ref = node.input[0]


def reducer_monoid(fdef: tw.FunctionDef) -> Optional[str]:
  """'max', 'min' or 'add' for a reducer function that is one such op of
  its two arguments; None for any other body."""
  args = [a.name for a in fdef.signature.input_arg]
  outs = [a.name for a in fdef.signature.output_arg]
  if len(args) != 2 or len(outs) != 1:
    return None
  nodes = {n.name: n for n in fdef.node_def}
  body = _source(fdef, nodes, fdef.ret[outs[0]])
  if not isinstance(body, tw.NodeDef) or body.op not in _MONOIDS:
    return None
  operands = [_source(fdef, nodes, i) for i in body.input
              if not i.startswith('^')]
  if sorted(o for o in operands if isinstance(o, str)) != sorted(args):
    return None
  return _MONOIDS[body.op]


def _xla_reduce_window(ctx, node, inputs):
  """XLA's ReduceWindow: each window folds its elements into the init
  value; padding takes no part (XLA skips it)."""
  x, init, window, strides, base, dil, padding = inputs
  x, init = same_device(x, init)
  window, strides = ints(window), ints(strides)
  base, dil, padding = ints(base), ints(dil), ints(padding)
  name = node.attr['computation'].func.name
  kind = reducer_monoid(ctx.function_def(name))
  if kind is not None:
    return [stablehlo.reduce_window(kind, window, strides, base, dil, padding,
                                    pad_with_init=False)(x, init)]
  if any(b != 1 for b in base):
    raise UnsupportedGraphError('XlaReduceWindow with base dilations')
  init = init.reshape(()).to(x.dtype)
  rank = len(window)

  def unfold(t, fill):
    t = stablehlo.unfold_windows(t, window, strides, dil, padding, fill)
    return t.reshape(*t.shape[:rank], -1)

  elements = unfold(x, init)
  inside = unfold(torch.ones_like(x, dtype=torch.bool), torch.tensor(False))
  acc = init.expand(elements.shape[:rank])
  for j in range(elements.shape[-1]):
    (step,) = ctx.call_function(name, [acc, elements[..., j]])
    acc = torch.where(inside[..., j], step, acc)
  return [acc]


def _xla_pad(ctx, node, inputs):
  x, value, low, high, interior = inputs
  x, value = same_device(x, value)
  return [stablehlo.pad(ints(low), ints(high), ints(interior))(x, value)]


def gather(operand, start_indices, slice_sizes, offset_dims,
           collapsed_slice_dims, start_index_map, index_vector_dim):
  """XLA's gather: each batch element of `start_indices` names a start
  (clamped so that the slice fits); the slices, their collapsed dims
  dropped, sit at `offset_dims` of the output."""
  rank = operand.dim()
  idx = start_indices.to(operand.device, torch.long)
  if index_vector_dim == idx.dim():
    idx = idx.unsqueeze(-1)
  else:
    idx = idx.movedim(index_vector_dim, -1)
  batch_shape = idx.shape[:-1]
  idx = idx.reshape(-1, idx.shape[-1])
  starts = torch.zeros(idx.shape[0], rank, dtype=torch.long,
                       device=operand.device)
  for j, d in enumerate(start_index_map):
    starts[:, d] = idx[:, j]
  limits = torch.tensor([operand.shape[d] - slice_sizes[d]
                         for d in range(rank)], device=operand.device)
  starts = torch.minimum(starts.clamp(min=0), limits)
  grids = []
  for d in range(rank):
    view = [-1] + [1] * rank
    view[1 + d] = slice_sizes[d]
    grids.append(starts[:, d].reshape(-1, *[1] * rank)
                 + torch.arange(slice_sizes[d],
                                device=operand.device).reshape(view))
  grids = torch.broadcast_tensors(*grids)
  slices = operand[tuple(grids)]  # (batch, *slice_sizes)
  kept = [d for d in range(rank) if d not in collapsed_slice_dims]
  slices = slices.reshape(len(starts), *[slice_sizes[d] for d in kept])
  out = slices.reshape(*batch_shape, *slices.shape[1:])
  n_out = len(batch_shape) + len(kept)
  batch_dims = [d for d in range(n_out) if d not in offset_dims]
  order = [0] * n_out
  for j, d in enumerate(batch_dims):
    order[d] = j
  for j, d in enumerate(offset_dims):
    order[d] = len(batch_shape) + j
  return out.permute(order)


def _xla_gather(ctx, node, inputs):
  operand, start_indices, slice_sizes = inputs
  numbers = _dimension_numbers(tw.GatherDimensionNumbers,
                               node.attr['dimension_numbers'].s)
  if numbers.operand_batching_dims or numbers.start_indices_batching_dims:
    raise UnsupportedGraphError('XlaGather with batching dims')
  return [gather(operand, start_indices, ints(slice_sizes),
                 list(numbers.offset_dims), list(numbers.collapsed_slice_dims),
                 list(numbers.start_index_map), numbers.index_vector_dim)]


def _xla_dynamic_slice(ctx, node, inputs):
  x, starts, sizes = inputs
  sizes = ints(sizes)
  index = []
  for d, (s, n) in enumerate(zip(ints(starts), sizes)):
    s = min(max(s, 0), x.shape[d] - n)
    index.append(slice(s, s + n))
  return [x[tuple(index)]]


# --- the plain form ----------------------------------------------------------


def _spatial(node, name, nhwc: bool, default=1) -> List[int]:
  values = _attr_ints(node, name)
  if not values:
    return [default, default]
  return values[1:3] if nhwc else values[2:4]


def conv_padding(padding: str, explicit: Sequence[int], sizes, kernel,
                 strides, dilations, nhwc: bool = True):
  """(lo, hi) a spatial dim of a TF convolution or pool: VALID none;
  SAME TF's split, the odd element at the end; EXPLICIT as given."""
  if padding == 'VALID':
    return [(0, 0)] * len(sizes)
  if padding == 'SAME':
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
      total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
      pads.append((total // 2, total - total // 2))
    return pads
  if padding == 'EXPLICIT':
    pairs = [tuple(explicit[2 * i:2 * i + 2]) for i in range(4)]
    return pairs[1:3] if nhwc else pairs[2:4]
  raise UnsupportedGraphError(f'padding {padding!r}')


def _nhwc(node) -> bool:
  fmt = _attr_str(node, 'data_format', 'NHWC')
  if fmt not in ('NHWC', 'NCHW'):
    raise UnsupportedGraphError(f'data_format {fmt}')
  return fmt == 'NHWC'


def _to_nchw(x, nhwc):
  return x.permute(0, 3, 1, 2) if nhwc else x


def _from_nchw(y, nhwc):
  return y.permute(0, 2, 3, 1) if nhwc else y


def _conv2d(ctx, node, inputs):
  x, w = same_device(*inputs)
  nhwc = _nhwc(node)
  x = _to_nchw(x, nhwc)
  strides, dilations = _spatial(node, 'strides', nhwc), _spatial(
      node, 'dilations', nhwc)
  kernel = [w.shape[0], w.shape[1]]
  (pt, pb), (pl, pr) = conv_padding(
      _attr_str(node, 'padding'), _attr_ints(node, 'explicit_paddings'),
      x.shape[2:], kernel, strides, dilations, nhwc)
  if any((pt, pb, pl, pr)):
    x = F.pad(x, (pl, pr, pt, pb))
  groups = x.shape[1] // w.shape[2]
  layout = torch.channels_last
  y = F.conv2d(x.contiguous(memory_format=layout),
               w.permute(3, 2, 0, 1).contiguous(memory_format=layout),
               stride=strides, dilation=dilations, groups=groups)
  return [_from_nchw(y, nhwc)]


def _conv2d_backprop_input(ctx, node, inputs):
  """The input gradient of a convolution: `conv_transpose` of the output
  gradient, cropped (or zero-extended) to the input's size."""
  sizes, w, dy = inputs
  w, dy = same_device(w, dy)
  nhwc = _nhwc(node)
  sizes = ints(sizes)
  spatial = (sizes[1:3] if nhwc else sizes[2:4]) if len(sizes) == 4 else sizes
  if w.shape[3] != dy.shape[3 if nhwc else 1]:
    raise UnsupportedGraphError('Conv2DBackpropInput with feature groups')
  dy = _to_nchw(dy, nhwc)
  strides, dilations = _spatial(node, 'strides', nhwc), _spatial(
      node, 'dilations', nhwc)
  kernel = [w.shape[0], w.shape[1]]
  pads = conv_padding(_attr_str(node, 'padding'),
                      _attr_ints(node, 'explicit_paddings'), spatial, kernel,
                      strides, dilations, nhwc)
  layout = torch.channels_last
  full = F.conv_transpose2d(
      dy.contiguous(memory_format=layout),
      w.permute(3, 2, 0, 1).contiguous(memory_format=layout),
      stride=strides, dilation=dilations)
  extend = [max(lo + n - full.shape[2 + j], 0)
            for j, ((lo, _), n) in enumerate(zip(pads, spatial))]
  if any(extend):
    full = F.pad(full, (0, extend[1], 0, extend[0]))
  y = full[:, :, pads[0][0]:pads[0][0] + spatial[0],
           pads[1][0]:pads[1][0] + spatial[1]]
  return [_from_nchw(y, nhwc)]


def _bias_add(ctx, node, inputs):
  x, bias = same_device(*inputs)
  if _attr_str(node, 'data_format', 'NHWC') == 'NCHW':
    return [x + bias.reshape(-1, *[1] * (x.dim() - 2))]
  return [x + bias]


def _max_pool(ctx, node, inputs):
  (x,) = inputs
  nhwc = _nhwc(node)
  ksize = _attr_ints(node, 'ksize')
  strides = _attr_ints(node, 'strides')
  outer = (0, 3) if nhwc else (0, 1)
  if any(ksize[d] != 1 or strides[d] != 1 for d in outer):
    raise UnsupportedGraphError('MaxPool over the batch or feature dim')
  x = _to_nchw(x, nhwc)
  kernel, step = _spatial(node, 'ksize', nhwc), _spatial(node, 'strides',
                                                         nhwc)
  (pt, pb), (pl, pr) = conv_padding(
      _attr_str(node, 'padding'), _attr_ints(node, 'explicit_paddings'),
      x.shape[2:], kernel, step, (1, 1), nhwc)
  if any((pt, pb, pl, pr)):
    x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
  return [_from_nchw(F.max_pool2d(x, kernel, step), nhwc)]


def _mat_mul(ctx, node, inputs):
  a, b = same_device(*inputs)
  if _attr_bool(node, 'transpose_a'):
    a = a.transpose(0, 1)
  if _attr_bool(node, 'transpose_b'):
    b = b.transpose(0, 1)
  return [a @ b]


def _batch_mat_mul(ctx, node, inputs):
  a, b = same_device(*inputs)
  if _attr_bool(node, 'adj_x'):
    a = a.transpose(-1, -2).conj()
  if _attr_bool(node, 'adj_y'):
    b = b.transpose(-1, -2).conj()
  return [torch.matmul(a, b)]


def _einsum(ctx, node, inputs):
  return [torch.einsum(_attr_str(node, 'equation'), *same_device(*inputs))]


def _pad(ctx, node, inputs):
  x, paddings = inputs[:2]
  value = inputs[2] if len(inputs) == 3 else None
  pairs = ints(paddings)
  torch_pad = []
  for d in reversed(range(x.dim())):
    torch_pad += [pairs[2 * d], pairs[2 * d + 1]]
  fill = 0 if value is None else value.reshape(()).item()
  return [F.pad(x, torch_pad, value=fill)]


def _gather_v2(ctx, node, inputs):
  params, indices, axis = inputs
  if _attr_int(node, 'batch_dims'):
    raise UnsupportedGraphError('GatherV2 with batch_dims')
  a = _int(axis) % params.dim()
  flat = indices.reshape(-1).to(params.device, torch.long)
  out = params.index_select(a, flat)
  return [out.reshape(*params.shape[:a], *indices.shape,
                      *params.shape[a + 1:])]


OPS: Dict[str, Callable] = {
    'Identity': _one(lambda x: x),
    'IdentityN': lambda ctx, node, inputs: list(inputs),
    'NoOp': lambda ctx, node, inputs: [],
    'StopGradient': _one(torch.Tensor.detach),
    'PreventGradient': _one(torch.Tensor.detach),
    'AddV2': _binary(torch.add),
    'Sub': _binary(torch.sub), 'Mul': _binary(torch.mul),
    'RealDiv': _binary(_real_div), 'Maximum': _binary(torch.maximum),
    'Minimum': _binary(torch.minimum), 'NotEqual': _binary(torch.ne),
    'Equal': _binary(torch.eq), 'Less': _binary(torch.lt),
    'Greater': _binary(torch.gt), 'LogicalOr': _binary(torch.logical_or),
    'Neg': _one(torch.neg), 'Abs': _one(torch.abs),
    'Square': _one(torch.square), 'Rsqrt': _one(torch.rsqrt),
    'Sqrt': _one(torch.sqrt), 'Tanh': _one(torch.tanh),
    'Exp': _one(torch.exp),
    'Log1p': _one(torch.log1p), 'Sigmoid': _one(torch.sigmoid),
    'Relu': _one(torch.relu), 'Erf': _one(torch.erf),
    'IsNan': _one(torch.isnan), 'SelectV2': _select, 'Cast': _cast,
    'Reshape': _reshape, 'BroadcastTo': _broadcast_to, 'Squeeze': _squeeze,
    'ExpandDims': _expand_dims, 'Transpose': _transpose,
    'ReverseV2': _reverse, 'ConcatV2': _concat, 'Pack': _pack,
    'Slice': _slice, 'StridedSlice': _strided_slice,
    'Sum': _reduction('sum'), 'Max': _reduction('max'),
    'Mean': _reduction('mean'),
    'Shape': _shape, 'Fill': _fill, 'Range': _range,
    'XlaConvV2': _xla_conv, 'XlaConv': _xla_conv,
    'XlaDotV2': _xla_dot, 'XlaDot': _xla_dot,
    'XlaReduceWindow': _xla_reduce_window, 'XlaPad': _xla_pad,
    'XlaGather': _xla_gather, 'XlaDynamicSlice': _xla_dynamic_slice,
    'Conv2D': _conv2d, 'Conv2DBackpropInput': _conv2d_backprop_input,
    'BiasAdd': _bias_add, 'MaxPool': _max_pool, 'MatMul': _mat_mul,
    'BatchMatMulV2': _batch_mat_mul, 'Einsum': _einsum, 'Pad': _pad,
    'PadV2': _pad, 'GatherV2': _gather_v2,
}
