"""A StableHLO (VHLO) module run as a program of torch ops on a device.

`Program(module, device)` turns the module that an `XlaCallModule` carries
(read by `io/mlir_bytecode.py`) into a list of steps, each a torch op on
slots of values, once; calling it runs them. The public `main` function is
the entry point; `func.call` runs the callee's steps in place. What
depends on no argument (the constants, and the ops only constants feed) is
computed once, when the program is built.

Op set (the VHLO names and versions): what the JAX package's exports of
the detector, aligner, rate predictor and MLP policy hold (the fixtures in
tests/data/torch_saved_models) and what `io/torch_to_stablehlo.py` emits:
the elementwise `abs`, `add`, `subtract`, `multiply`, `divide`, `negate`,
`maximum`, `rsqrt`, `tanh`, `logistic`, `exponential`, `log_plus_one`,
`compare`, `select`; and `broadcast_in_dim`, `reshape`, `transpose`,
`slice`, `concatenate`, `constant`, `dot_general`, `convolution`, `reduce`,
`reduce_window`, `func`, `call`, `return`. Any other op raises
`UnsupportedOpError` naming it. Semantics kept:

  * `dot_general`: result dims are the batch dims, then the lhs's free
    dims, then the rhs's, in order;
  * `convolution`: any dimension numbers (flax's NHWC / HWIO included),
    padding (negative crops), rhs dilation, strides and
    `feature_group_count`, 2-D ones in the channels-last layout; lhs
    dilation (flax's ConvTranspose) runs as `conv_transpose` and only
    with window stride 1, no rhs dilation, one group and a padding that
    maps onto it; window reversal, `batch_group_count` != 1 and the other
    lhs-dilated forms are refused;
  * `reduce` and `reduce_window`: the body must be one add or max of its
    two arguments (refused otherwise), folded with the init value; windows
    pad with the init value;
  * `compare`: the six directions, FLOAT (IEEE) and TOTALORDER (sign-
    magnitude order of the bits) on floats, SIGNED on integers, UNSIGNED
    on unsigned ones;
  * broadcasting is always the explicit `broadcast_in_dim`.

Every float op runs in full float32: TF32 is off inside the program for
matmuls and cuDNN whatever the global setting (and restored after), and
the module's `precision_config` is read and ignored.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from putting_dune_torch.io import mlir_bytecode as mb


class UnsupportedOpError(NotImplementedError):
  """An op (or an op's attribute) the interpreter does not run."""


_DTYPES = {
    'bool_v1': torch.bool, 'f16_v1': torch.float16, 'bf16_v1': torch.bfloat16,
    'f32_v1': torch.float32, 'f64_v1': torch.float64, 'i8_v1': torch.int8,
    'i16_v1': torch.int16, 'i32_v1': torch.int32, 'i64_v1': torch.int64,
    'ui8_v1': torch.uint8, 'index_v1': torch.int64,
}
_NUMPY = {
    'bool_v1': np.dtype('?'), 'f16_v1': np.dtype('<f2'),
    'f32_v1': np.dtype('<f4'), 'f64_v1': np.dtype('<f8'),
    'i8_v1': np.dtype('i1'), 'i16_v1': np.dtype('<i2'),
    'i32_v1': np.dtype('<i4'), 'i64_v1': np.dtype('<i8'),
    'ui8_v1': np.dtype('u1'), 'index_v1': np.dtype('<i8'),
}


def _refuse(what: str) -> UnsupportedOpError:
  return UnsupportedOpError(
      f'{what} is not run by the StableHLO interpreter; see ROADMAP queue 1')


def element_dtype(t: mb.Type) -> torch.dtype:
  try:
    return _DTYPES[t.kind]
  except KeyError:
    raise _refuse(f'element type {t.dialect}.{t.kind}') from None


def tensor_type(t: mb.Type) -> Tuple[Tuple[int, ...], torch.dtype]:
  if t.dialect != 'vhlo' or t.kind not in ('tensor_v1', 'tensor_v1_encoded'):
    raise _refuse(f'type {t.dialect}.{t.kind}')
  shape, element = mb.tensor_type_of(t)
  if any(d < 0 for d in shape):
    raise _refuse('a dynamic shape')
  return shape, element_dtype(element)


def dense_array(attr: mb.Attr) -> np.ndarray:
  """The numpy value of a `tensor_v1` attribute (a splat is one element's
  bytes). i1 is read as MLIR reads it: one byte 0x00 or 0xff is a splat,
  anything else eight elements a byte, the first in the lowest bit."""
  if attr.kind != 'tensor_v1':
    raise _refuse(f'attribute {attr.dialect}.{attr.kind} as a tensor')
  t, data = attr.args
  shape, element = mb.tensor_type_of(t)
  if element.kind not in _NUMPY:
    raise _refuse(f'element type {element.kind} in a constant')
  dtype = _NUMPY[element.kind]
  size = math.prod(shape)
  if element.kind == 'bool_v1':
    raw = np.frombuffer(data, np.uint8)
    if raw.size == 1 and raw[0] in (0, 0xff):
      return np.full(shape, bool(raw[0]))
    if raw.size * 8 < size:
      raise mb.BytecodeError(f'i1 constant of {raw.size} bytes for shape '
                             f'{shape}')
    return np.unpackbits(raw, bitorder='little')[:size].astype(bool).reshape(
        shape)
  values = np.frombuffer(data, dtype)
  if values.size == 1 and size != 1:
    return np.full(shape, values[0], dtype)
  if values.size != size:
    raise mb.BytecodeError(f'constant of {values.size} elements for shape '
                           f'{shape}')
  return values.reshape(shape).copy()


def ints(attr: mb.Attr) -> Tuple[int, ...]:
  return tuple(int(v) for v in dense_array(attr).reshape(-1))


def int_attr(attr: mb.Attr) -> int:
  if attr.kind != 'integer_v1':
    raise _refuse(f'attribute {attr.kind} as an integer')
  width = mb.type_width(attr.args[0])
  value = attr.args[1]
  return value - (1 << width) if value >> (width - 1) else value


def bools(attr: mb.Attr) -> Tuple[bool, ...]:
  return tuple(bool(v) for v in dense_array(attr).reshape(-1))


def _string(attr: mb.Attr) -> str:
  if attr.kind not in ('string_v1', 'string'):
    raise _refuse(f'attribute {attr.kind} as a string')
  return attr.args[0]


@contextlib.contextmanager
def full_float32():
  """TF32 off for matmuls and cuDNN (cuDNN on), restored after."""
  matmul = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
      yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = matmul


# --- the ops -----------------------------------------------------------------


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
  bits = {torch.float32: torch.int32, torch.float64: torch.int64,
          torch.float16: torch.int16, torch.bfloat16: torch.int16}[x.dtype]
  k = x.view(bits)
  mask = torch.iinfo(bits).max
  return torch.where(k < 0, k ^ mask, k)


_COMPARE = {0: torch.eq, 1: torch.ne, 2: torch.ge, 3: torch.gt, 4: torch.le,
            5: torch.lt}


def _compare(direction: int, compare_type: int) -> Callable:
  fn = _COMPARE.get(direction)
  if fn is None:
    raise _refuse(f'compare direction {direction}')
  if compare_type == 2:  # TOTALORDER

    def total(a, b):
      if a.is_floating_point():
        return fn(_total_order_key(a), _total_order_key(b))
      return fn(a, b)

    return total
  if compare_type == 4:  # UNSIGNED

    def unsigned(a, b):
      if a.is_floating_point() or a.is_signed():
        raise _refuse(f'an UNSIGNED compare of {a.dtype}')
      return fn(a, b)

    return unsigned
  if compare_type not in (0, 1, 3):
    raise _refuse(f'compare type {compare_type}')
  return fn


_UNARY = {
    'abs_v1': torch.abs, 'negate_v1': torch.neg, 'rsqrt_v2': torch.rsqrt,
    'tanh_v2': torch.tanh, 'logistic_v2': torch.sigmoid,
    'exponential_v2': torch.exp, 'log_plus_one_v2': torch.log1p,
}
_BINARY = {
    'add_v1': torch.add, 'subtract_v1': torch.sub, 'multiply_v1': torch.mul,
    'maximum_v1': torch.maximum,
}


def _divide(a, b):
  if a.is_floating_point():
    return torch.div(a, b)
  return torch.div(a, b, rounding_mode='trunc')


# The shape ops, products, convolutions and windows below take plain ints,
# so that the TF op table (`io/tf_ops.py`) runs the `Xla*` ops through the
# same code as this interpreter.


def broadcast_in_dim(shape, dims):
  rank = len(shape)
  order = sorted(range(len(dims)), key=lambda i: dims[i])
  view = [1] * rank

  def run(x):
    if order != list(range(len(dims))):
      x = x.permute(order)
    for i, d in enumerate(sorted(dims)):
      view[d] = x.shape[i]
    return x.reshape(view).expand(shape)

  return run


def dot_general(lhs_batch, rhs_batch, lhs_contract, rhs_contract,
                out_shape=None):
  """Result dims: the batch dims, then the lhs's free dims, then the
  rhs's (`out_shape` None: as they come)."""
  lhs_batch, rhs_batch = list(lhs_batch), list(rhs_batch)
  lhs_contract, rhs_contract = list(lhs_contract), list(rhs_contract)

  def run(a, b):
    lf = [d for d in range(a.dim()) if d not in lhs_batch + lhs_contract]
    rf = [d for d in range(b.dim()) if d not in rhs_batch + rhs_contract]
    batch = [a.shape[d] for d in lhs_batch]
    m = math.prod(a.shape[d] for d in lf)
    n = math.prod(b.shape[d] for d in rf)
    k = math.prod(a.shape[d] for d in lhs_contract)
    nb = math.prod(batch)
    a2 = a.permute(lhs_batch + lf + lhs_contract).reshape(nb, m, k)
    b2 = b.permute(rhs_batch + rhs_contract + rf).reshape(nb, k, n)
    shape = out_shape
    if shape is None:
      shape = batch + [a.shape[d] for d in lf] + [b.shape[d] for d in rf]
    return torch.bmm(a2, b2).reshape(shape)

  return run


def _convolution(props: Dict[str, mb.Attr], kernel_shape,
                 out_shape) -> Callable:
  get = lambda k: int_attr(props[k])
  n = len(ints(props['input_spatial_dimensions']))
  return convolution(
      input_batch=get('input_batch_dimension'),
      input_feature=get('input_feature_dimension'),
      input_spatial=ints(props['input_spatial_dimensions']),
      kernel_input=get('kernel_input_feature_dimension'),
      kernel_output=get('kernel_output_feature_dimension'),
      kernel_spatial=ints(props['kernel_spatial_dimensions']),
      output_batch=get('output_batch_dimension'),
      output_feature=get('output_feature_dimension'),
      output_spatial=ints(props['output_spatial_dimensions']),
      strides=ints(props['window_strides']) or (1,) * n,
      padding=ints(props['padding']) or (0,) * (2 * n),
      lhs_dilation=ints(props['lhs_dilation']) or (1,) * n,
      rhs_dilation=ints(props['rhs_dilation']) or (1,) * n,
      feature_group_count=get('feature_group_count'),
      batch_group_count=get('batch_group_count'),
      window_reversal=any(bools(props['window_reversal'])),
      kernel_shape=kernel_shape, out_shape=out_shape)


def convolution(*, input_batch, input_feature, input_spatial, kernel_input,
                kernel_output, kernel_spatial, output_batch, output_feature,
                output_spatial, strides, padding, lhs_dilation, rhs_dilation,
                feature_group_count=1, batch_group_count=1,
                window_reversal=False, kernel_shape,
                out_shape=None) -> Callable:
  """XLA's convolution of (input, kernel): the dimension numbers, the
  padding as (lo, hi) a spatial dim, flat."""
  if batch_group_count != 1:
    raise _refuse('convolution with batch_group_count != 1')
  in_b, in_f, in_s = input_batch, input_feature, tuple(input_spatial)
  k_i, k_o, k_s = kernel_input, kernel_output, tuple(kernel_spatial)
  o_b, o_f, o_s = output_batch, output_feature, tuple(output_spatial)
  n = len(in_s)
  if n not in (1, 2, 3):
    raise _refuse(f'convolution over {n} spatial dimensions')
  groups = feature_group_count
  strides, lhs_dil = tuple(strides), tuple(lhs_dilation)
  rhs_dil, pad = tuple(rhs_dilation), tuple(padding)
  if window_reversal:
    raise _refuse('convolution with window reversal')
  conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
  conv_t = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[n - 1]
  out_perm = [0] * (n + 2)
  out_perm[o_b], out_perm[o_f] = 0, 1
  for j, d in enumerate(o_s):
    out_perm[d] = 2 + j
  layout = torch.channels_last if n == 2 else torch.contiguous_format
  finish = ((lambda y: y.permute(out_perm)) if out_shape is None
            else (lambda y: y.permute(out_perm).reshape(out_shape)))

  # An lhs-dilated convolution (flax's and torch's transposed convolutions)
  # runs as `conv_transpose` over the input: the flipped, transposed
  # kernel, padding k - 1 - lo, `output_padding` hi - lo (cut off again
  # where it is negative). The forms that do not map onto it are refused.
  transpose = any(d != 1 for d in lhs_dil)
  if transpose:
    if (groups != 1 or any(st != 1 for st in strides)
        or any(d != 1 for d in rhs_dil)):
      raise _refuse('lhs-dilated convolution with a window stride, rhs '
                    'dilation or feature groups')
    k = [kernel_shape[d] for d in k_s]
    tpad, extra, cut = [], [], []
    for j in range(n):
      lo, hi = pad[2 * j], pad[2 * j + 1]
      tpad.append(k[j] - 1 - lo)
      extra.append(max(hi - lo, 0))
      cut.append(max(lo - hi, 0))
    if min(tpad) < 0 or any(e >= d for e, d in zip(extra, lhs_dil)):
      raise _refuse(f'lhs-dilated convolution with padding {pad}')
    crop_t = (slice(None), slice(None)) + tuple(
        slice(0, -c if c else None) for c in cut)

  def run(x, w):
    x = x.permute([in_b, in_f, *in_s])
    w = w.permute([k_o, k_i, *k_s])
    if transpose:
      wt = torch.flip(w, dims=list(range(2, 2 + n))).transpose(0, 1)
      y = conv_t(x.contiguous(memory_format=layout),
                 wt.contiguous(memory_format=layout), stride=lhs_dil,
                 padding=tpad, output_padding=extra)
      if any(cut):
        y = y[crop_t]
      return finish(y)
    torch_pad = []
    crop = []
    for j in reversed(range(n)):
      lo, hi = pad[2 * j], pad[2 * j + 1]
      torch_pad += [max(lo, 0), max(hi, 0)]
    if any(torch_pad):
      x = F.pad(x, torch_pad)
    for j in range(n):
      lo, hi = pad[2 * j], pad[2 * j + 1]
      size = x.shape[2 + j]
      crop.append(slice(-lo if lo < 0 else 0, size + hi if hi < 0 else size))
    if any(s.start or s.stop != x.shape[2 + j] for j, s in enumerate(crop)):
      x = x[(slice(None), slice(None)) + tuple(crop)]
    y = conv(x.contiguous(memory_format=layout),
             w.contiguous(memory_format=layout), stride=strides,
             dilation=rhs_dil, groups=groups)
    return finish(y)

  return run


_REDUCERS = {'add_v1': 'add', 'maximum_v1': 'max'}


def _reduction_body(op: mb.Op) -> str:
  """'add' or 'max' for a body that is one such op of its two block
  arguments; refused otherwise."""
  if len(op.regions) != 1 or len(op.regions[0].blocks) != 1:
    raise _refuse(f'{op.name} whose body is not one block')
  block = op.regions[0].blocks[0]
  if len(block.args) != 2 or len(block.ops) != 2:
    raise _refuse(f'{op.name} over several operands, or a body of more than '
                  'one op')
  body, ret = block.ops
  kind = _REDUCERS.get(body.name.split('.', 1)[1])
  if (kind is None or ret.name != 'vhlo.return_v1'
      or ret.operands != body.results
      or set(map(id, body.operands)) != set(map(id, block.args))):
    raise _refuse(f'{op.name} whose body is not one add or max '
                  f'({body.name})')
  return kind


COMBINE = {'add': torch.add, 'max': torch.maximum, 'min': torch.minimum}


def _reduce(kind: str, dims: Tuple[int, ...]):
  combine = COMBINE[kind]

  def run(x, init):
    if dims:
      x = x.sum(dim=dims) if kind == 'add' else x.amax(dim=dims)
    return combine(x, init)

  return run


def unfold_windows(x, window, strides, dilations, padding, fill):
  """x's windows, unfolded: x's dims (each the count of windows along it),
  then the window's dims. `padding` is (lo, hi) a dim, flat, filled with
  `fill` (a 0-d tensor)."""
  rank = len(window)
  torch_pad = []
  for j in reversed(range(rank)):
    torch_pad += [padding[2 * j], padding[2 * j + 1]]
  if any(torch_pad):
    x = F.pad(x, torch_pad, value=float(fill))
  for d in range(rank):
    span = (window[d] - 1) * dilations[d] + 1
    x = x.unfold(d, span, strides[d])
    if dilations[d] != 1:
      x = x[..., ::dilations[d]]
  return x


def _reduce_window(kind: str, props: Dict[str, mb.Attr], out_shape):
  window = ints(props['window_dimensions'])
  rank = len(window)
  return reduce_window(
      kind, window, ints(props['window_strides']) or (1,) * rank,
      ints(props['base_dilations']) or (1,) * rank,
      ints(props['window_dilations']) or (1,) * rank,
      ints(props['padding']) or (0,) * (2 * rank), out_shape)


IDENTITIES = {'add': 0.0, 'max': -math.inf, 'min': math.inf}


def reduce_window(kind: str, window, strides, base_dilations,
                  window_dilations, padding, out_shape=None,
                  pad_with_init=True):
  """`reduce_window` whose body is `kind` ('add', 'max' or 'min'), folded
  with the init value. Windows pad with the init value, as StableHLO
  specifies; `pad_with_init=False` pads with the monoid's identity, so
  that padding takes no part, as XLA's `ReduceWindow` skips it."""
  rank = len(window)
  if any(b != 1 for b in base_dilations):
    raise _refuse('reduce_window with base dilations')
  if any(p < 0 for p in padding):
    raise _refuse('reduce_window with negative padding')
  combine = COMBINE[kind]
  reducer = {'add': torch.sum, 'max': torch.amax, 'min': torch.amin}[kind]

  def run(x, init):
    init_value = init.reshape(()).to(x.dtype)
    fill = init_value if pad_with_init else torch.tensor(IDENTITIES[kind])
    x = unfold_windows(x, window, strides, window_dilations, padding, fill)
    y = combine(reducer(x, dim=tuple(range(rank, 2 * rank))), init_value)
    return y if out_shape is None else y.reshape(out_shape)

  return run


def pad(low, high, interior):
  """`pad`: interior padding between elements, then edge padding (a
  negative edge crops)."""

  def run(x, value):
    fill = value.reshape(()).to(x.dtype)
    if any(interior):
      shape = [(s - 1) * (i + 1) + 1 if s else 0
               for s, i in zip(x.shape, interior)]
      spread = fill.expand(shape).clone()
      spread[tuple(slice(None, None, i + 1) for i in interior)] = x
      x = spread
    torch_pad = []
    for lo, hi in zip(reversed(low), reversed(high)):
      torch_pad += [max(lo, 0), max(hi, 0)]
    if any(torch_pad):
      x = F.pad(x, torch_pad, value=float(fill))
    crop = tuple(slice(-lo if lo < 0 else 0, s + hi if hi < 0 else s)
                 for lo, hi, s in zip(low, high, x.shape))
    return x[crop]

  return run


def _select_and_scatter(op: mb.Op) -> Callable:
  """`select_and_scatter` whose select is GE (the first largest of each
  window wins, as in max pooling's gradient) and whose scatter adds:
  each source value is added at its window's selected element."""
  attrs = op.attributes
  window = ints(attrs['window_dimensions'])
  rank = len(window)
  strides = (ints(attrs['window_strides']) if 'window_strides' in attrs
             else (1,) * rank)
  if 'padding' in attrs and any(ints(attrs['padding'])):
    raise _refuse('select_and_scatter with padding')
  select, scatter = op.regions if len(op.regions) == 2 else (None, None)
  body = select.blocks[0].ops[0] if select else None
  if (body is None or body.name != 'vhlo.compare_v1'
      or body.attributes['comparison_direction'].args[0] != 2
      or body.operands != select.blocks[0].args):
    raise _refuse('select_and_scatter whose select is not a >= b')
  if _reduction_body(mb.Op(name=op.name, loc=None, regions=[scatter])
                     ) != 'add':
    raise _refuse('select_and_scatter whose scatter does not add')

  def windows(x):
    for d in range(rank):
      x = x.unfold(d, window[d], strides[d])
    return x.reshape(*x.shape[:rank], -1)

  def run(x, source, init):
    # torch.argmax gives the first largest of each window (row-major).
    first = torch.argmax(windows(x), dim=-1, keepdim=True)
    flat = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    where = torch.gather(windows(flat), -1, first).reshape(-1)
    out = init.reshape(()).to(source.dtype).expand(x.numel()).clone()
    return out.index_add_(0, where, source.reshape(-1)).reshape(x.shape)

  return run


def slice_op(starts, limits, strides):
  index = tuple(slice(s, l, st) for s, l, st in zip(starts, limits, strides))
  return lambda x: x[index]


# --- the program -------------------------------------------------------------


class _Function:
  """One func: its argument slots, steps, returned slots, and the values
  of the slots that do not depend on the arguments (computed once, when
  the program is built)."""

  def __init__(self, name: str, num_args: int):
    self.name = name
    self.arg_slots = list(range(num_args))
    self.steps: List[Tuple[Callable, List[int], List[int]]] = []
    self.result_slots: List[int] = []
    self.num_slots = num_args
    self.constants: Dict[int, torch.Tensor] = {}


class Program:
  """A VHLO module compiled to steps of torch ops on `device`."""

  def __init__(self, module: mb.Module, device):
    self.device = torch.device(device)
    root = module.root
    if root.name != 'builtin.module':
      raise mb.BytecodeError(f'root op {root.name} is not builtin.module')
    self._funcs: Dict[str, mb.Op] = {}
    for op in root.regions[0].blocks[0].ops:
      if op.name != 'vhlo.func_v1':
        raise _refuse(f'top-level op {op.name}')
      self._funcs[_string(op.attributes['sym_name'])] = op
    if 'main' not in self._funcs:
      raise mb.BytecodeError('the module has no main function')
    self._compiled: Dict[str, _Function] = {}
    self.main = self._compile('main')
    func_type = self._funcs['main'].attributes['function_type'].args[0]
    self.input_types = [tensor_type(t) for t in func_type.args[0]]
    self.output_types = [tensor_type(t) for t in func_type.args[1]]

  def _compile(self, name: str) -> _Function:
    if name in self._compiled:
      return self._compiled[name]
    if name not in self._funcs:
      raise mb.BytecodeError(f'call to an unknown function {name!r}')
    op = self._funcs[name]
    block = op.regions[0].blocks[0]
    fn = _Function(name, len(block.args))
    slots = {id(v): i for i, v in enumerate(block.args)}
    self._compiled[name] = fn
    for inner in block.ops:
      if inner.name == 'vhlo.return_v1':
        fn.result_slots = [slots[id(v)] for v in inner.operands]
        break
      run = self._op(inner)
      ins = [slots[id(v)] for v in inner.operands]
      outs = []
      for v in inner.results:
        slots[id(v)] = fn.num_slots
        outs.append(fn.num_slots)
        fn.num_slots += 1
      if all(i in fn.constants for i in ins):
        # Constants, and what only constants feed (broadcast weights,
        # folded scales): computed here once, not on every call.
        with torch.no_grad(), full_float32():
          results = run(*[fn.constants[i] for i in ins])
        fn.constants.update(zip(outs, results))
      else:
        fn.steps.append((run, ins, outs))
    return fn

  def _op(self, op: mb.Op) -> Callable:
    """A callable of the op's operand tensors giving a tuple of results."""
    short = op.name.split('.', 1)[1] if op.name.startswith('vhlo.') else None
    attrs = op.attributes
    out_types = [tensor_type(v.type) for v in op.results
                 ] if short != 'call_v1' else []
    one = lambda f: (lambda *xs: (f(*xs),))
    if short in _UNARY:
      return one(_UNARY[short])
    if short in _BINARY:
      return one(_BINARY[short])
    if short == 'divide_v1':
      return one(_divide)
    if short == 'constant_v1':
      value = torch.as_tensor(dense_array(attrs['value'])).to(self.device)
      return lambda: (value,)
    if short == 'compare_v1':
      fn = _compare(attrs['comparison_direction'].args[0],
                    attrs['compare_type'].args[0])
      return one(fn)
    if short == 'select_v1':
      return one(torch.where)
    if short == 'broadcast_in_dim_v1':
      return one(broadcast_in_dim(out_types[0][0],
                                   ints(attrs['broadcast_dimensions'])))
    if short == 'reshape_v1':
      shape = out_types[0][0]
      return one(lambda x: x.reshape(shape))
    if short == 'transpose_v1':
      perm = ints(attrs['permutation'])
      return one(lambda x: x.permute(perm))
    if short == 'slice_v1':
      return one(slice_op(ints(attrs['start_indices']),
                        ints(attrs['limit_indices']), ints(attrs['strides'])))
    if short == 'convert_v1':
      dtype = out_types[0][1]
      return one(lambda x: x.to(dtype))
    if short == 'pad_v1':
      return one(pad(ints(attrs['edge_padding_low']),
                      ints(attrs['edge_padding_high']),
                      ints(attrs['interior_padding'])))
    if short == 'reverse_v1':
      dims = list(ints(attrs['dimensions']))
      return one(lambda x: torch.flip(x, dims))
    if short == 'select_and_scatter_v1':
      return one(_select_and_scatter(op))
    if short == 'concatenate_v1':
      dim = int_attr(attrs['dimension'])
      return lambda *xs: (torch.cat(xs, dim=dim),)
    if short == 'dot_general_v2':
      return one(dot_general(
          ints(attrs['lhs_batching_dimensions']),
          ints(attrs['rhs_batching_dimensions']),
          ints(attrs['lhs_contracting_dimensions']),
          ints(attrs['rhs_contracting_dimensions']), out_types[0][0]))
    if short == 'convolution_v1':
      return one(_convolution(attrs, tensor_type(op.operands[1].type)[0],
                              out_types[0][0]))
    if short == 'reduce_v1':
      if len(op.results) != 1:
        raise _refuse(f'{op.name} over several operands')
      return one(_reduce(_reduction_body(op), ints(attrs['dimensions'])))
    if short == 'reduce_window_v1':
      if len(op.results) != 1:
        raise _refuse(f'{op.name} over several operands')
      return one(_reduce_window(_reduction_body(op), attrs, out_types[0][0]))
    if short == 'call_v1':
      callee = self._compile(_string(attrs['callee']))
      return lambda *xs: self._run(callee, xs)
    raise _refuse(f'op {op.name}')

  def _run(self, fn: _Function, args: Sequence[torch.Tensor]) -> tuple:
    slots: List[Optional[torch.Tensor]] = [None] * fn.num_slots
    slots[:len(args)] = args
    for i, value in fn.constants.items():
      slots[i] = value
    for run, ins, outs in fn.steps:
      results = run(*[slots[i] for i in ins])
      for i, r in zip(outs, results):
        slots[i] = r
    return tuple(slots[i] for i in fn.result_slots)

  def __call__(self, *args) -> Tuple[torch.Tensor, ...]:
    if len(args) != len(self.input_types):
      raise ValueError(f'main takes {len(self.input_types)} arguments, got '
                       f'{len(args)}')
    tensors = []
    for x, (shape, dtype) in zip(args, self.input_types):
      x = torch.as_tensor(x, device=self.device)
      if tuple(x.shape) != shape:
        raise ValueError(f'argument of shape {tuple(x.shape)}, main takes '
                         f'{shape}')
      tensors.append(x.to(dtype))
    with torch.no_grad(), full_float32():
      out = self._run(self.main, tensors)
    return tuple(o.contiguous() for o in out)


def load(data: bytes, device) -> Program:
  """Reads a portable artifact and compiles it for `device`."""
  return Program(mb.read_module(data), device)
