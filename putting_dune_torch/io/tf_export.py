"""TF SavedModel export and load without TensorFlow (port of
putting_dune_tpu/io/tf_export.py).

`export_tf_saved_model(fn, input_shape, save_dir, input_name=)` writes
what `jax2tf.convert` + `tf.saved_model.save` write for a one-input
function: `saved_model.pb` whose `__call__` concrete function wraps one
`XlaCallModule` (version 10) holding `fn` as a StableHLO portable
artifact (`io/torch_to_stablehlo.py`, bytes by `io/mlir_bytecode.py`), its
weights as constants; a `serving_default` signature whose outputs are
`output_0`, ...; and `variables/` (a tensor bundle holding only the
object graph, as TF writes for a model without variables). The module
lists `platforms` ['CPU', 'CUDA'] and takes the platform index that more
than one platform requires, so TF on a CPU and a GPU serving stack both
run the file. Left out of what TF writes: the traced save and restore
functions with their `saver_def`, `fingerprint.pb` and the
`stripped_op_list`; a model without variables has nothing to save, and TF
2.21 loads the file without them (`tf.saved_model.load`, and the C++
loader that serving uses).

`load_tf_saved_model(save_dir, device=)` reads such a file, one the JAX
package wrote, or a graph of TF ops such as jax2tf's pre-native path
wrote (the reference's 2023 policies) in either of its modes, without TF:
it walks the object graph to `__call__` and the signatures, binds nested
inputs (dicts, tuples, lists, flattened as `tf.nest` flattens them: dict
keys sorted) to the concrete function's input signature, follows
`StatefulPartitionedCall` / `PartitionedCall` through the function library
from the functions' arguments, and interprets `Const`, variable reads
(values from `variables/`), `XlaCallModule` (run by `io/stablehlo.py` on
`device`) and the TF ops of `io/tf_ops.py`'s table: the `Xla*` ops of
jax2tf's `enable_xla=True` graphs and the plain ops (`Conv2D`, `MatMul`,
`MaxPool`, ...) of its `enable_xla=False` ones. Any other op raises
`UnsupportedGraphError` naming it, its node and the file (ROADMAP queue 1
lists what is refused: control flow, string ops, `XlaCallModule` versions
other than 10). Unlike TF it applies no platform check: the port is no
XLA backend, so it runs a module lowered for any platform, passing the
index of the one that matches `device` (CUDA or CPU) where the module
takes one. Products and convolutions run in full float32.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from putting_dune_torch import device as device_lib
from putting_dune_torch.io import mlir_bytecode as mb
from putting_dune_torch.io import stablehlo
from putting_dune_torch.io import tensor_bundle
from putting_dune_torch.io import tensorproto
from putting_dune_torch.io import tf_ops
from putting_dune_torch.io import torch_to_stablehlo
from putting_dune_torch.proto import tf_wire as tw

XLA_CALL_MODULE_VERSION = 10
PLATFORMS = ('CPU', 'CUDA')
# The versions TF 2.21's saver writes.
GRAPH_PRODUCER, GRAPH_MIN_CONSUMER = 2474, 12
_CONFIG_PROTO = (b'\n\x07\n\x03CPU\x10\x01\n\x07\n\x03GPU\x10\x002\x02J\x00'
                 b'8\x01\x82\x01\x00\x92\x01\x02J\x00')
_OBJECT_GRAPH_KEY = '_CHECKPOINTABLE_OBJECT_GRAPH'
_GRADIENT_OP_TYPE = 'CustomGradient-1'
_PREVENT_GRADIENT = (b'The jax2tf-converted function does not support '
                     b'gradients. Use `with_gradient` parameter to enable '
                     b'gradients')


UnsupportedGraphError = tf_ops.UnsupportedGraphError


# --- writing -----------------------------------------------------------------


def _shape(shape) -> tw.TensorShapeProto:
  return tw.TensorShapeProto(
      dim=[tw.TensorShapeProtoDim(size=int(d)) for d in shape])


def _shapes(*shapes) -> tw.AttrValue:
  return tw.AttrValue(list=tw.AttrValueListValue(
      shape=[_shape(s) for s in shapes]))


def _types(n: int, dtype: int = tw.DT_FLOAT) -> tw.AttrValue:
  return tw.AttrValue(list=tw.AttrValueListValue(type=[dtype] * n))


def _node(name: str, op: str, inputs=(), device: str = '',
          **attrs) -> tw.NodeDef:
  node = tw.NodeDef(name=name, op=op, input=list(inputs), attr=attrs)
  if device:
    node.device = device
  return node


def _arg(name: str, dtype: int = tw.DT_FLOAT) -> tw.OpDefArgDef:
  return tw.OpDefArgDef(name=name, type=dtype)


def _arg_attr(index: int, shape, name: str) -> tw.FunctionDefArgAttrEntry:
  entry = tw.FunctionDefArgAttrEntry(value=tw.FunctionDefArgAttrs(attr={
      '_output_shapes': _shapes(shape),
      '_user_specified_name': tw.AttrValue(s=name.encode())}))
  if index:
    entry.key = index
  return entry


def _function(name, inputs, outputs, nodes, ret, control, input_shapes,
              arg_names) -> tw.FunctionDef:
  return tw.FunctionDef(
      signature=tw.OpDef(
          name=name, input_arg=[_arg(n, d) for n, d in inputs],
          output_arg=[_arg(n, d) for n, d in outputs], is_stateful=True,
          control_output=[control]),
      node_def=nodes, ret=ret, control_ret={control: control},
      attr={'_construction_context': tw.AttrValue(s=b'kEagerRuntime'),
            '_input_shapes': _shapes(*input_shapes)},
      arg_attr=[_arg_attr(i, s, n)
                for i, (s, n) in enumerate(zip(input_shapes, arg_names))])


def _call(name: str, inputs, fn: str, n_in: int, n_out: int, out_shapes):
  return _node(
      name, 'StatefulPartitionedCall', inputs, Tin=_types(n_in),
      Tout=_types(n_out),
      _collective_manager_ids=tw.AttrValue(list=tw.AttrValueListValue()),
      _output_shapes=_shapes(*out_shapes),
      _read_only_resource_inputs=tw.AttrValue(list=tw.AttrValueListValue()),
      config_proto=tw.AttrValue(s=_CONFIG_PROTO),
      f=tw.AttrValue(func=tw.NameAttrList(name=fn)))


def _xla_call(name, inputs, in_shapes, out_shapes, module_bytes):
  return _node(
      name, 'XlaCallModule', inputs, Sout=_shapes(*out_shapes),
      Tin=_types(len(in_shapes)), Tout=_types(len(out_shapes)),
      _output_shapes=_shapes(*out_shapes),
      module=tw.AttrValue(s=module_bytes),
      platforms=tw.AttrValue(list=tw.AttrValueListValue(
          s=[p.encode() for p in PLATFORMS])),
      use_shardy_partitioner=tw.AttrValue(b=True),
      version=tw.AttrValue(i=XLA_CALL_MODULE_VERSION))


def _identity(name, source, shape) -> tw.NodeDef:
  return _node(name, 'Identity', [source], T=tw.AttrValue(type=tw.DT_FLOAT),
               _output_shapes=_shapes(shape))


def _converted_fn(name, input_name, input_shape, module_bytes, out_shapes,
                  gradient_op_type=None):
  """jax2tf's converted function. Without a gradient each output passes a
  `PreventGradient`; with one, the outputs and the input pass one
  `IdentityN` whose `_gradient_op_type` names the registered gradient."""
  n = len(out_shapes)
  suffix = lambda i: '' if i == 0 else f'_{i}'
  nodes = [_identity('jax2tf_arg_0', input_name, input_shape),
           _xla_call('XlaCallModule', ['jax2tf_arg_0:output:0'],
                     [input_shape], out_shapes, module_bytes)]
  if gradient_op_type is None:
    for i, s in enumerate(out_shapes):
      nodes.append(_node(f'PreventGradient{suffix(i)}', 'PreventGradient',
                         [f'XlaCallModule:output:{i}'],
                         T=tw.AttrValue(type=tw.DT_FLOAT),
                         _output_shapes=_shapes(s),
                         message=tw.AttrValue(s=_PREVENT_GRADIENT)))
    sources = [f'PreventGradient{suffix(i)}:output:0' for i in range(n)]
  else:
    nodes.append(_node(
        'IdentityN', 'IdentityN',
        [f'XlaCallModule:output:{i}' for i in range(n)]
        + ['jax2tf_arg_0:output:0'], T=_types(n + 1),
        _gradient_op_type=tw.AttrValue(s=gradient_op_type.encode()),
        _output_shapes=_shapes(*out_shapes, input_shape)))
    sources = [f'IdentityN:output:{i}' for i in range(n)]
  for i, (source, s) in enumerate(zip(sources, out_shapes)):
    nodes.append(_identity(f'jax2tf_out{suffix(i)}', source, s))
  nodes += _identities([f'jax2tf_out{suffix(i)}:output:0' for i in range(n)],
                       out_shapes)
  nodes.append(_node('NoOp', 'NoOp', ['^XlaCallModule'],
                     _output_shapes=_shapes()))
  ret = {f'identity{suffix(i)}': f'Identity{suffix(i)}:output:0'
         for i in range(n)}
  return _function(name, [(input_name, tw.DT_FLOAT)],
                   [(k, tw.DT_FLOAT) for k in ret], nodes, ret,
                   'XlaCallModule', [input_shape], [input_name])


_CAPTURED_INPUT = 'jax2tf_vjp_jax2tf_arg_0_jax2tf_arg_0'


def _gradient_fn(name, input_shape, vjp_bytes, out_shapes):
  """jax2tf's gradient function: `result_grads_i`, one an output of the
  IdentityN (the last, the input's, unused), then the captured input; the
  VJP module gives the input's cotangent."""
  n = len(out_shapes)
  grad_shapes = list(out_shapes) + [input_shape]
  nodes = [_identity('jax2tf_vjp/jax2tf_arg_0', _CAPTURED_INPUT,
                     input_shape)]
  nodes += [_identity(f'jax2tf_vjp/jax2tf_arg_{i + 1}', f'result_grads_{i}',
                      s) for i, s in enumerate(out_shapes)]
  nodes.append(_xla_call(
      'jax2tf_vjp/XlaCallModule',
      [f'jax2tf_vjp/jax2tf_arg_{i}:output:0' for i in range(n + 1)],
      [input_shape] + list(out_shapes), [input_shape], vjp_bytes))
  nodes.append(_identity('jax2tf_vjp/jax2tf_out',
                         'jax2tf_vjp/XlaCallModule:output:0', input_shape))
  nodes += _identities(['jax2tf_vjp/jax2tf_out:output:0'], [input_shape])
  nodes.append(_node('NoOp', 'NoOp', ['^jax2tf_vjp/XlaCallModule'],
                     _output_shapes=_shapes()))
  names = [f'result_grads_{i}' for i in range(n + 1)] + [_CAPTURED_INPUT]
  return _function(name, [(a, tw.DT_FLOAT) for a in names],
                   [('identity', tw.DT_FLOAT)], nodes,
                   {'identity': 'Identity:output:0'},
                   'jax2tf_vjp/XlaCallModule',
                   grad_shapes + [input_shape], names)


def _identities(sources, shapes, dtype=tw.DT_FLOAT) -> List[tw.NodeDef]:
  return [_node('Identity' if i == 0 else f'Identity_{i}', 'Identity',
                [src, '^NoOp'], T=tw.AttrValue(type=dtype),
                _output_shapes=_shapes(s))
          for i, (src, s) in enumerate(zip(sources, shapes))]


def _signature_wrapper(name, converted, input_name, input_shape, out_shapes):
  n = len(out_shapes)
  nodes = [_call('StatefulPartitionedCall', [input_name], converted, 1, n,
                 out_shapes)]
  nodes += _identities([f'StatefulPartitionedCall:output:{i}'
                        for i in range(n)], out_shapes)
  nodes.append(_node('NoOp', 'NoOp', ['^StatefulPartitionedCall'],
                     _output_shapes=_shapes()))
  ret = {('identity' if i == 0 else f'identity_{i}'):
         ('Identity' if i == 0 else f'Identity_{i}') + ':output:0'
         for i in range(n)}
  return _function(name, [(input_name, tw.DT_FLOAT)],
                   [(k, tw.DT_FLOAT) for k in ret], nodes, ret,
                   'StatefulPartitionedCall', [input_shape], [input_name])


def _none() -> tw.StructuredValue:
  return tw.StructuredValue(none_value=tw.NoneValue())


def _strings(values) -> tw.StructuredValue:
  return tw.StructuredValue(list_value=tw.ListValue(
      values=[tw.StructuredValue(string_value=v) for v in values]))


def _fullargspec(args, kwonlyargs) -> tw.StructuredValue:
  values = [('args', _strings(args)), ('varargs', _none()),
            ('varkw', _none()), ('defaults', _none()),
            ('kwonlyargs', _strings(kwonlyargs)),
            ('kwonlydefaults', _none()),
            ('annotations', tw.StructuredValue(dict_value=tw.DictValue()))]
  return tw.StructuredValue(named_tuple_value=tw.NamedTupleValue(
      name='FullArgSpec',
      values=[tw.PairValue(key=k, value=v) for k, v in values]))


def _spec(name, shape) -> tw.StructuredValue:
  return tw.StructuredValue(tensor_spec_value=tw.TensorSpecProto(
      name=name, shape=_shape(shape), dtype=tw.DT_FLOAT))


def _tuple(values) -> tw.StructuredValue:
  return tw.StructuredValue(tuple_value=tw.TupleValue(values=list(values)))


def _object_graph(converted, wrapper, input_name, input_shape, out_shapes,
                  is_tuple, gradient=None) -> tw.SavedObjectGraph:
  user = lambda identifier: tw.SavedUserObject(
      identifier=identifier, version=tw.VersionDef(producer=1,
                                                   min_consumer=1))
  ref = lambda node_id, name: tw.ObjectReference(node_id=node_id,
                                                 local_name=name)
  call_spec = tw.FunctionSpec(
      fullargspec=_fullargspec(['args_tf_0'], []),
      input_signature=_tuple([_spec(input_name, input_shape)]))
  nodes = [
      tw.SavedObject(children=[ref(1, '__call__'), ref(2, 'signatures')],
                     user_object=user('_generic_user_object')),
      tw.SavedObject(children=[ref(3, 'trace_0')],
                     dependencies=[ref(3, 'trace_0')],
                     function=tw.SavedFunction(concrete_functions=[converted],
                                               function_spec=call_spec)),
      tw.SavedObject(children=[ref(4, 'serving_default')],
                     user_object=user('signature_map')),
      tw.SavedObject(bare_concrete_function=tw.SavedBareConcreteFunction(
          concrete_function_name=converted, argument_keywords=[input_name],
          allowed_positional_arguments=1, function_spec=tw.FunctionSpec(
              fullargspec=_fullargspec(['args_tf_0'], []),
              input_signature=_none()))),
      tw.SavedObject(bare_concrete_function=tw.SavedBareConcreteFunction(
          concrete_function_name=wrapper, argument_keywords=[input_name],
          allowed_positional_arguments=1, function_spec=tw.FunctionSpec(
              fullargspec=_fullargspec([], [input_name]),
              input_signature=_none()))),
  ]
  if is_tuple:
    outputs = _tuple(_spec(f'tensor_{i}', s) for i, s in enumerate(out_shapes))
  else:
    outputs = _spec('unknown', out_shapes[0])
  concrete = {
      converted: tw.SavedConcreteFunction(
          canonicalized_input_signature=_tuple([
              _tuple([_spec(input_name, input_shape)]),
              tw.StructuredValue(dict_value=tw.DictValue())]),
          output_signature=outputs),
      wrapper: tw.SavedConcreteFunction(
          canonicalized_input_signature=_tuple([
              _tuple([]), tw.StructuredValue(dict_value=tw.DictValue(
                  fields={input_name: _spec(input_name, input_shape)}))]),
          output_signature=tw.StructuredValue(dict_value=tw.DictValue(
              fields={f'output_{i}': _spec(f'output_{i}', s)
                      for i, s in enumerate(out_shapes)}))),
  }
  if gradient is not None:
    # The gradient function's captured input: the converted function's
    # `jax2tf_arg_0`, an object of its own that the function binds.
    nodes.append(tw.SavedObject(captured_tensor=tw.CapturedTensor(
        name='jax2tf_arg_0:0', concrete_function=converted)))
    n = len(out_shapes)
    grads = [_spec(f'result_grads_{i}', s)
             for i, s in enumerate(list(out_shapes) + [input_shape])]
    concrete[gradient] = tw.SavedConcreteFunction(
        bound_inputs=[len(nodes) - 1],
        canonicalized_input_signature=_tuple([
            _tuple([_none()] + grads),
            tw.StructuredValue(dict_value=tw.DictValue())]),
        output_signature=tw.StructuredValue(list_value=tw.ListValue(
            values=[_none()] * n + [_spec(f'tensor_{n}', input_shape)])))
  return tw.SavedObjectGraph(nodes=nodes, concrete_functions=concrete)


def _checkpoint_graph() -> bytes:
  """The TrackableObjectGraph TF checkpoints for the five objects."""
  ref = lambda node_id, name: tw.ObjectReference(node_id=node_id,
                                                 local_name=name)
  nodes = [tw.TrackableObject(children=[ref(1, '__call__'),
                                        ref(2, 'signatures')]),
           tw.TrackableObject(children=[ref(3, 'trace_0')]),
           tw.TrackableObject(children=[ref(4, 'serving_default')]),
           tw.TrackableObject(), tw.TrackableObject()]
  return tw.TrackableObjectGraph(nodes=nodes).SerializeToString()


def write_saved_model(module_bytes: bytes, input_shape, out_shapes,
                      save_dir: str, *, input_name: str = 'input',
                      is_tuple: bool = False,
                      vjp_bytes: bytes = None) -> None:
  """Writes `saved_model.pb` and `variables/` around a portable artifact
  whose main takes the platform index and one float32 input. Given
  `vjp_bytes` (a module of the platform index, the input and one
  cotangent an output, giving the input's cotangent), the outputs carry
  it as their registered gradient, as `jax2tf.convert(with_gradient=True)`
  saves them."""
  n = len(out_shapes)
  converted = '__inference_converted_fun_tf_1'
  wrapper = '__inference_signature_wrapper_2'
  placeholder = f'serving_default_{input_name}'
  functions = [_converted_fn(converted, input_name, input_shape, module_bytes,
                             out_shapes,
                             None if vjp_bytes is None else _GRADIENT_OP_TYPE),
               _signature_wrapper(wrapper, converted, input_name, input_shape,
                                  out_shapes)]
  gradient, registered = None, []
  if vjp_bytes is not None:
    gradient = '__inference_internal_grad_fn_3'
    functions.append(_gradient_fn(gradient, input_shape, vjp_bytes,
                                  out_shapes))
    registered = [tw.RegisteredGradient(gradient_func=gradient,
                                        registered_op_type=_GRADIENT_OP_TYPE)]
  graph = tw.GraphDef(
      node=[
          _node(placeholder, 'Placeholder',
                _output_shapes=_shapes(input_shape),
                dtype=tw.AttrValue(type=tw.DT_FLOAT),
                shape=tw.AttrValue(shape=_shape(input_shape))),
          _call('StatefulPartitionedCall', [placeholder], wrapper, 1, n,
                out_shapes),
          _node('NoOp', 'NoOp'),
      ],
      library=tw.FunctionDefLibrary(function=functions,
                                    registered_gradients=registered),
      versions=tw.VersionDef(producer=GRAPH_PRODUCER,
                             min_consumer=GRAPH_MIN_CONSUMER))
  signature = tw.SignatureDef(
      inputs={input_name: tw.TensorInfo(name=f'{placeholder}:0',
                                        dtype=tw.DT_FLOAT,
                                        tensor_shape=_shape(input_shape))},
      outputs={f'output_{i}': tw.TensorInfo(
          name=f'StatefulPartitionedCall:{i}', dtype=tw.DT_FLOAT,
          tensor_shape=_shape(s)) for i, s in enumerate(out_shapes)},
      method_name='tensorflow/serving/predict')
  init = tw.SignatureDef(outputs={'__saved_model_init_op': tw.TensorInfo(
      name='NoOp', tensor_shape=tw.TensorShapeProto(unknown_rank=True))})
  meta = tw.MetaGraphDef(
      meta_info_def=tw.MetaInfoDef(tags=['serve'],
                                   stripped_default_attrs=True),
      graph_def=graph,
      collection_def={'saved_model_main_op': tw.CollectionDef(
          node_list=tw.CollectionDefNodeList(value=['NoOp']))},
      signature_def={'__saved_model_init_op': init,
                     'serving_default': signature},
      object_graph_def=_object_graph(converted, wrapper, input_name,
                                     input_shape, out_shapes, is_tuple,
                                     gradient))
  os.makedirs(os.path.join(save_dir, 'variables'), exist_ok=True)
  with open(os.path.join(save_dir, 'saved_model.pb'), 'wb') as f:
    f.write(tw.SavedModel(saved_model_schema_version=1,
                          meta_graphs=[meta]).SerializeToString())
  tensor_bundle.write_bundle(
      os.path.join(save_dir, 'variables', 'variables'),
      {_OBJECT_GRAPH_KEY: _checkpoint_graph()})


def export_tf_saved_model(
    fn: Callable,
    input_shape: Sequence[int],
    save_dir: str,
    *,
    input_name: str = 'input',
    with_gradient: bool = False,
) -> None:
  """Exports `fn` (a torch module or function of one float32 tensor) at
  `input_shape` as a TF SavedModel. It is traced on the device its
  parameters are on (the CPU for a function without any). With
  `with_gradient`, the SavedModel also holds fn's vector-Jacobian product
  (`torch_to_stablehlo.export_vjp`) as the outputs' gradient, so TF's
  `GradientTape` (and this module's loader, under autograd)
  differentiates the loaded function; without it, the outputs stop
  gradients, as jax2tf's do."""
  input_shape = tuple(int(d) for d in input_shape)
  device = torch.device('cpu')
  if isinstance(fn, torch.nn.Module):
    tensor = next(iter(fn.parameters()), None)
    if tensor is None:
      tensor = next(iter(fn.buffers()), None)
    if tensor is not None:
      device = tensor.device
  module, out_shapes, is_tuple = torch_to_stablehlo.export(
      fn, input_shape, device)
  vjp_bytes = None
  if with_gradient:
    vjp_bytes = mb.write_module(torch_to_stablehlo.export_vjp(
        fn, input_shape, out_shapes, device))
  write_saved_model(mb.write_module(module), input_shape, out_shapes,
                    save_dir, input_name=input_name, is_tuple=is_tuple,
                    vjp_bytes=vjp_bytes)


# --- loading -----------------------------------------------------------------


def _tensor_value(proto: tw.TensorProto):
  if proto.dtype == tw.DT_STRING:
    shape = tuple(int(d.size) for d in proto.tensor_shape.dim)
    return np.asarray(list(proto.string_val), dtype=object).reshape(shape)
  return tensorproto.tensor_proto_to_ndarray(proto)


class _GraphFunction:
  """A FunctionDef of the library, interpreted on demand: the nodes its
  outputs need, run in an order each node's inputs precede (found once,
  without recursion, so that a deep graph runs as a shallow one)."""

  def __init__(self, loader: 'LoadedSavedModel', fdef: tw.FunctionDef):
    self.loader = loader
    self.fdef = fdef
    self.inputs = [a.name for a in fdef.signature.input_arg]
    self.outputs = [a.name for a in fdef.signature.output_arg]
    self.nodes = {n.name: n for n in fdef.node_def}
    # Each XlaCallModule node's program, built at its first call.
    self.programs: Dict[str, stablehlo.Program] = {}
    # Each Const node's tensors, made at its first run.
    self.constants: Dict[str, list] = {}
    self._order = None

  def __call__(self, args: Sequence) -> List:
    values: Dict[str, list] = {name: [a] for name, a in zip(self.inputs,
                                                              args)}
    if self._order is None:
      self._order = self._schedule()
    for node in self._order:
      values[node.name] = self._run(node, values)
    return [self._lookup(self.fdef.ret[name], values)
            for name in self.outputs]

  def _captures(self, node: tw.NodeDef) -> List[str]:
    """What a custom gradient's function captures (none for other nodes,
    and for a gradient the file does not register: that raises when the
    gradient is taken)."""
    op_type = node.attr.get('_gradient_op_type')
    if node.op != 'IdentityN' or op_type is None:
      return []
    try:
      return self.loader.registered_gradient(op_type.s.decode(),
                                             self.fdef)[1]
    except UnsupportedGraphError:
      return []

  def _schedule(self) -> List[tw.NodeDef]:
    args = set(self.inputs)
    order, done = [], set()
    stack = [(self.fdef.ret[name].split(':')[0], False)
             for name in reversed(self.outputs)]
    while stack:
      name, expanded = stack.pop()
      if name in done or name in args:
        continue
      if expanded:
        done.add(name)
        order.append(self.nodes[name])
        continue
      node = self.nodes.get(name)
      if node is None:
        raise self.loader.error(f'{self.fdef.signature.name} refers to no '
                                f'node {name!r}')
      stack.append((name, True))
      deps = [i for i in node.input if not i.startswith('^')]
      for ref in reversed(deps + self._captures(node)):
        stack.append((ref.split(':')[0], False))
    return order

  @staticmethod
  def _lookup(ref: str, values: Dict[str, list]):
    if ref in values:
      return values[ref][0]
    parts = ref.split(':')
    outs = values[parts[0]]
    return outs[0] if len(parts) == 1 else outs[int(parts[-1])]

  def _run(self, node: tw.NodeDef, values) -> list:
    if node.op == 'Const':
      if node.name not in self.constants:
        self.constants[node.name] = self.loader.run_op(node, [], self)
      return self.constants[node.name]
    inputs = [self._lookup(i, values) for i in node.input
              if not i.startswith('^')]
    op_type = node.attr.get('_gradient_op_type')
    if (node.op == 'IdentityN' and op_type is not None
        and torch.is_grad_enabled()):
      # A custom gradient: the registered function, given the outputs'
      # cotangents and what it captured from this function.
      name, captures = self.loader.registered_gradient(op_type.s.decode(),
                                                       self.fdef)
      captured = [self._lookup(c, values) for c in captures]
      return list(_CustomGradient.apply(self.loader, name, len(inputs),
                                        *inputs, *captured))
    return self.loader.run_op(node, inputs, self)


class _CustomGradient(torch.autograd.Function):
  """The identity on a node's inputs whose backward runs a registered
  gradient function: its inputs are one cotangent an output (zeros for
  none) then the captured tensors, its outputs (None for an input without
  a gradient) the inputs' cotangents."""

  @staticmethod
  def forward(ctx, loader, name, n_in, *tensors):
    ctx.loader, ctx.name = loader, name
    ctx.save_for_backward(*tensors[n_in:])
    ctx.inputs = [(t.shape, t.dtype) for t in tensors[:n_in]]
    return tuple(t.clone() for t in tensors[:n_in])

  @staticmethod
  def backward(ctx, *grads):
    grads = [torch.zeros(s, dtype=d, device=ctx.loader.device)
             if g is None else g for g, (s, d) in zip(grads, ctx.inputs)]
    with torch.no_grad():
      flat = ctx.loader.call_function(ctx.name,
                                      grads + list(ctx.saved_tensors))
    out = ctx.loader.gradient_outputs(ctx.name, flat)
    return (None, None, None, *out, *[None] * len(ctx.saved_tensors))


def _kind(structure: tw.StructuredValue):
  fields = structure.ListFields()
  return fields[0][0] if fields else None


class _Function:
  """A callable concrete function: positional and keyword inputs bound to
  its input signature (nested ones flattened as `tf.nest` flattens them),
  the captured variables appended, the outputs in its output structure."""

  def __init__(self, loader, name: str, captured: Sequence[torch.Tensor],
               inputs: tw.StructuredValue, outputs: tw.StructuredValue,
               arg_names: Sequence[str], keywords: Sequence[str] = (),
               positional_keywords: int = 0):
    self._loader = loader
    self._name = name
    self._captured = list(captured)
    self._structure = outputs
    # (args, kwargs) of the canonicalized input signature.
    if _kind(inputs) != 'tuple_value' or len(inputs.tuple_value.values) != 2:
      raise loader.error(f'{name}: no input signature (args, kwargs)')
    args, kwargs = inputs.tuple_value.values
    self._args = list(args.tuple_value.values)
    self._kwargs = dict(kwargs.dict_value.fields)
    self._arg_names = list(arg_names)
    # Keyword inputs that may also come positionally, in this order.
    self._keywords = list(keywords)
    self._positional_keywords = positional_keywords

  def _bind(self, args, kwargs) -> list:
    args, kwargs = list(args), dict(kwargs)
    n = len(self._args)
    extra = args[n:]
    if len(extra) > self._positional_keywords:
      raise TypeError(f'{self._name} takes {n + self._positional_keywords} '
                      f'positional inputs, got {len(args)}')
    for key, value in zip(self._keywords, extra):
      if key in kwargs:
        raise TypeError(f'input {key!r} given twice')
      kwargs[key] = value
    args = args[:n]
    for i in range(len(args), n):
      names = [self._arg_names[i]] if i < len(self._arg_names) else []
      spec = self._args[i]
      if _kind(spec) == 'tensor_spec_value':
        names.append(spec.tensor_spec_value.name)
      name = next((k for k in names if k in kwargs), None)
      if name is None:
        raise TypeError(f'missing input {names[0] if names else i!r}')
      args.append(kwargs.pop(name))
    missing = [k for k in self._kwargs if k not in kwargs]
    if missing:
      raise TypeError(f'missing input {missing[0]!r}')
    unexpected = [k for k in kwargs if k not in self._kwargs]
    if unexpected:
      raise TypeError(f'unexpected inputs {sorted(unexpected)}')
    flat = []
    for i, (value, spec) in enumerate(zip(args, self._args)):
      self._flatten(value, spec, flat, f'argument {i}')
    for key in sorted(self._kwargs):
      self._flatten(kwargs[key], self._kwargs[key], flat, repr(key))
    return flat

  def _flatten(self, value, spec: tw.StructuredValue, flat: list, path: str):
    kind = _kind(spec)
    if kind == 'tensor_spec_value':
      flat.append(self._loader.to_device(value, spec.tensor_spec_value))
    elif kind == 'dict_value':
      fields = spec.dict_value.fields
      if not isinstance(value, Mapping) or sorted(value) != sorted(fields):
        keys = sorted(value) if isinstance(value, Mapping) else type(value)
        raise TypeError(f'{path}: a dict of keys {sorted(fields)} is '
                        f'expected, got {keys}')
      for key in sorted(fields):
        self._flatten(value[key], fields[key], flat, f'{path}[{key!r}]')
    elif kind in ('tuple_value', 'list_value'):
      specs = getattr(spec, kind).values
      if (not isinstance(value, (tuple, list))
          or len(value) != len(specs)):
        raise TypeError(f'{path}: a sequence of {len(specs)} is expected')
      for i, (v, s) in enumerate(zip(value, specs)):
        self._flatten(v, s, flat, f'{path}[{i}]')
    elif kind in ('none_value', None):
      if value is not None:
        raise TypeError(f'{path}: None is expected')
    else:
      raise self._loader.error(f'{self._name}: an input structure of kind '
                               f'{kind}')

  def __call__(self, *args, **kwargs):
    tensors = self._bind(args, kwargs)
    # Under autograd, gradients flow through the TF ops and through
    # registered gradients (the modules run without autograd, as
    # PreventGradient would have it).
    with stablehlo.full_float32():
      flat = self._loader.call_function(self._name,
                                        tensors + self._captured)
    flat = [self._loader.to_output(t) for t in flat]
    return _pack(self._structure, flat, self._loader)


def _pack(structure: tw.StructuredValue, flat: list, loader):
  kind = _kind(structure)
  if kind == 'tensor_spec_value':
    return flat.pop(0)
  if kind in ('tuple_value', 'list_value'):
    values = getattr(structure, kind).values
    out = [_pack(v, flat, loader) for v in values]
    return tuple(out) if kind == 'tuple_value' else out
  if kind == 'dict_value':
    fields = structure.dict_value.fields
    return {k: _pack(fields[k], flat, loader) for k in sorted(fields)}
  if kind == 'none_value' or kind is None:
    return None
  raise loader.error(f'an output structure of kind {kind}')


def _fullargspec_args(spec: tw.FunctionSpec) -> List[str]:
  """The `args` of a FunctionSpec's FullArgSpec (`self` dropped for a
  method)."""
  if _kind(spec.fullargspec) != 'named_tuple_value':
    return []
  for pair in spec.fullargspec.named_tuple_value.values:
    if pair.key == 'args' and _kind(pair.value) == 'list_value':
      names = [v.string_value for v in pair.value.list_value.values]
      return names[1:] if spec.is_method else names
  return []


class LoadedSavedModel:
  """A SavedModel loaded without TF: call it as its `__call__`; its
  `signatures` map names to functions returning {output key: tensor}.
  Every UnsupportedGraphError it raises names the file, and the node or
  object at fault."""

  def __init__(self, save_dir: str, device):
    self.device = device_lib.resolve_device(device)
    self.path = save_dir
    with open(os.path.join(save_dir, 'saved_model.pb'), 'rb') as f:
      saved = tw.SavedModel.FromString(f.read())
    metas = [m for m in saved.meta_graphs if 'serve' in m.meta_info_def.tags]
    if not metas:
      raise self.error('no meta graph tagged serve')
    meta = metas[0]
    self._library = {f.signature.name: f
                     for f in meta.graph_def.library.function}
    self._gradients = {g.registered_op_type: g.gradient_func
                       for g in meta.graph_def.library.registered_gradients}
    self._functions: Dict[str, _GraphFunction] = {}
    graph = meta.object_graph_def
    self._nodes = graph.nodes
    self._concrete = graph.concrete_functions
    self._variables = self._read_variables(save_dir)
    root = self._nodes[0]
    children = {c.local_name: c.node_id for c in root.children}
    self._call = None
    if '__call__' in children:
      self._call = self._callable(children['__call__'])
    self.signatures = {}
    if 'signatures' in children:
      for c in self._nodes[children['signatures']].children:
        self.signatures[c.local_name] = self._callable(c.node_id)

  def error(self, what: str, node: tw.NodeDef = None) -> UnsupportedGraphError:
    """An UnsupportedGraphError naming this file (and `node`)."""
    where = '' if node is None else f'node {node.name!r} ({node.op}): '
    err = UnsupportedGraphError(f'{self.path}: {where}{what}')
    err.located = True
    return err

  def _read_variables(self, save_dir: str) -> Dict[int, torch.Tensor]:
    prefix = os.path.join(save_dir, 'variables', 'variables')
    if not os.path.exists(f'{prefix}.index'):
      return {}
    _, tensors = tensor_bundle.read_bundle(prefix)
    graph_bytes = tensors.get(_OBJECT_GRAPH_KEY)
    if not graph_bytes:
      return {}
    graph = tw.TrackableObjectGraph.FromString(graph_bytes)
    out = {}
    for node_id, node in enumerate(graph.nodes):
      for attr in node.attributes:
        if attr.name == 'VARIABLE_VALUE':
          value = tensors[attr.checkpoint_key]
          if not isinstance(value, np.ndarray):
            raise self.error(f'object {node_id}: a string variable '
                             f'({attr.checkpoint_key})')
          out[node_id] = torch.as_tensor(value).to(self.device)
    return out

  def _callable(self, node_id: int) -> _Function:
    node = self._nodes[node_id]
    keywords, positional_keywords = [], 0
    if node.HasField('function'):
      names = list(node.function.concrete_functions)
      if len(names) != 1:
        raise self.error(f'object {node_id}: a function with {len(names)} '
                         'concrete functions')
      name = names[0]
      arg_names = _fullargspec_args(node.function.function_spec)
    elif node.HasField('bare_concrete_function'):
      bare = node.bare_concrete_function
      name = bare.concrete_function_name
      arg_names = _fullargspec_args(bare.function_spec)
      keywords = list(bare.argument_keywords)
      positional_keywords = int(bare.allowed_positional_arguments)
    else:
      raise self.error(f'object {node_id} is not a function')
    concrete = self._concrete[name]
    captured = []
    for bound in concrete.bound_inputs:
      if bound not in self._variables:
        raise self.error(
            f'object {node_id}: {name} captures object {bound}, which is no '
            'variable with a value in variables/')
      captured.append(self._variables[bound])
    return _Function(self, name, captured,
                     concrete.canonicalized_input_signature,
                     concrete.output_signature, arg_names, keywords,
                     positional_keywords)

  def registered_gradient(self, op_type: str, fdef: tw.FunctionDef):
    """(the gradient function registered for `op_type`, references in
    `fdef` to the tensors it captures)."""
    if op_type not in self._gradients:
      raise self.error(f'{fdef.signature.name}: no gradient registered for '
                       f'{op_type}')
    name = self._gradients[op_type]
    refs = []
    for bound in self._concrete[name].bound_inputs:
      node = self._nodes[bound]
      if (not node.HasField('captured_tensor')
          or node.captured_tensor.concrete_function != fdef.signature.name):
        raise self.error(
            f'{name} captures object {bound}, which is no tensor of '
            f'{fdef.signature.name}')
      refs.append(node.captured_tensor.name)  # 'node:index'
    return name, refs

  def gradient_outputs(self, name: str, flat) -> list:
    """A gradient function's outputs in its output structure (None where
    an input has no gradient)."""
    return _pack(self._concrete[name].output_signature, list(flat), self)

  def __call__(self, *args, **kwargs):
    if self._call is None:
      raise TypeError('the SavedModel has no __call__')
    return self._call(*args, **kwargs)

  def to_device(self, x, spec: tw.TensorSpecProto = None) -> torch.Tensor:
    """An input on the device; floats in the dtype of its `spec`."""
    if not isinstance(x, torch.Tensor):
      x = torch.as_tensor(np.asarray(x))
    if spec is not None and spec.dtype in tf_ops.DTYPES:
      want = tf_ops.DTYPES[spec.dtype]
      if x.is_floating_point() and want.is_floating_point:
        x = x.to(want)
    return x.to(self.device)

  def to_output(self, x):
    return x.to(self.device) if isinstance(x, torch.Tensor) else x

  def function_def(self, name: str) -> tw.FunctionDef:
    if name not in self._library:
      raise self.error(f'no function {name!r} in the library')
    return self._library[name]

  def call_function(self, name: str, args: Sequence) -> List:
    if name not in self._functions:
      self._functions[name] = _GraphFunction(self, self.function_def(name))
    return self._functions[name](args)

  def run_op(self, node: tw.NodeDef, inputs: list,
             fn: _GraphFunction) -> list:
    op = node.op
    try:
      if op == 'Const':
        value = _tensor_value(node.attr['value'].tensor)
        if value.dtype == object:
          return [value]
        tensor = torch.as_tensor(value)
        if tf_ops.on_host(tensor.dtype, tensor.numel()):
          return [tensor]
        return [tensor.to(self.device)]
      if op == 'ReadVariableOp':  # the captured variable's value itself
        return [inputs[0]]
      if op in ('StatefulPartitionedCall', 'PartitionedCall'):
        return self.call_function(node.attr['f'].func.name, inputs)
      if op == 'XlaCallModule':
        return self._xla_call_module(node, inputs, fn)
      run = tf_ops.OPS.get(op)
      if run is None:
        raise UnsupportedGraphError(
            f'TF op {op} is not in the loader\'s table (io/tf_ops.py); '
            'see ROADMAP queue 1')
      return run(self, node, inputs)
    except (UnsupportedGraphError, stablehlo.UnsupportedOpError) as e:
      if getattr(e, 'located', False):
        raise
      raise self.error(str(e), node) from None

  def _xla_call_module(self, node, inputs, fn: _GraphFunction) -> list:
    attr = node.attr
    version = attr['version'].i
    if version != XLA_CALL_MODULE_VERSION:
      raise UnsupportedGraphError(
          f'XlaCallModule version {version} (this loader runs version '
          f'{XLA_CALL_MODULE_VERSION}); see ROADMAP queue 1')
    none = tw.AttrValue()
    if attr.get('dim_args_spec', none).list.s:
      raise UnsupportedGraphError('XlaCallModule with dim_args_spec')
    if attr.get('has_token_input_output', none).b:
      raise UnsupportedGraphError('XlaCallModule with tokens')
    program = fn.programs.get(node.name)
    if program is None:
      program = fn.programs[node.name] = stablehlo.load(attr['module'].s,
                                                        self.device)
    platforms = [p.decode() for p in attr.get('platforms', none).list.s]
    args = [self.to_device(x) for x in inputs]
    if len(platforms) > 1:
      wanted = 'CUDA' if self.device.type == 'cuda' else 'CPU'
      index = platforms.index(wanted) if wanted in platforms else 0
      args.insert(0, torch.tensor(index, dtype=torch.int32,
                                  device=self.device))
    return list(program(*args))


def load_tf_saved_model(save_dir: str, device=None) -> LoadedSavedModel:
  """Loads a SavedModel exported by export_tf_saved_model (or by the JAX
  package's) on `device` (CUDA unless asked otherwise)."""
  return LoadedSavedModel(save_dir, device)
