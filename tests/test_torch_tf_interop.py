"""TF SavedModel interop without TensorFlow: the files, the bytecode, the
interpreter and the agent.

  * `proto/tf_wire.py`'s messages hold the field numbers, names and kinds
    of the installed TensorFlow's descriptors, and parse then re-serialize
    TF's own `saved_model.pb` to the same bytes;
  * `io/tensor_bundle.py` reads and writes TF's `variables/` byte for
    byte, and bundles of numeric tensors both ways with TF's checkpoint
    reader;
  * `io/mlir_bytecode.py`: every JAX fixture reads, writes and reads back
    the same module, and MLIR's own deserializer prints the rewritten
    bytes as it prints JAX's (debug locations included); unknown bytecode
    and VHLO versions, and ops whose properties it does not know, are
    refused, naming them;
  * `io/stablehlo.py` on the committed JAX fixtures gives JAX's recorded
    outputs; an unknown op is refused by name;
  * a SavedModel with variables (params as tf.Variables around a jax2tf
    function) loads with its `ReadVariableOp`s, and a graph of plain TF
    ops (`MatMul` of a variable) computes x @ w; graphs of TF ops are
    held in test_torch_tf_graphs.py;
  * the port's `TfSavedModelAgent` and the JAX one agree action for action
    on the committed JAX policy export, over three raw observations and a
    live `relative_random_simple` episode.

The JAX exports run here are in test_torch_tf_interop_models.py (the
shipped rate predictor and MLP) and test_torch_tf_interop_unets.py (the
UNets and the `--export_tf` CLIs), each file a few tests so that each
stays well under 30 s.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')

from putting_dune_torch.agents import eval_agent as t_eval_agent  # pylint: disable=g-import-not-at-top
from putting_dune_torch.io import mlir_bytecode as mb
from putting_dune_torch.io import stablehlo
from putting_dune_torch.io import tensor_bundle
from putting_dune_torch.io import tf_export as t_tf_export
from putting_dune_torch.io import torch_to_stablehlo
from putting_dune_torch.proto import tf_wire
import torch_tf_checks

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::FutureWarning',
                                        'ignore::DeprecationWarning')

FIXTURES = (pathlib.Path(__file__).resolve().parent / 'data'
            / 'torch_saved_models')
NAMES = ('mlp_policy', 'rate_predictor', 'atom_detector', 'image_aligner')
# The JAX test's own tolerance for the UNets (tests/test_detection_and_
# alignment_models.py), 1e-5 for the MLPs.
TOLERANCES = {'mlp_policy': (1e-5, 1e-5), 'rate_predictor': (1e-5, 1e-6),
              'atom_detector': (1e-3, 1e-4), 'image_aligner': (1e-3, 1e-4)}


def _module_bytes(name: str) -> bytes:
  with open(FIXTURES / name / 'saved_model' / 'saved_model.pb', 'rb') as f:
    saved = tf_wire.SavedModel.FromString(f.read())
  for fn in saved.meta_graphs[0].graph_def.library.function:
    for node in fn.node_def:
      if node.op == 'XlaCallModule':
        return node.attr['module'].s
  raise AssertionError(f'{name}: no XlaCallModule')


def _outputs(name: str):
  return [np.load(FIXTURES / name / f'output_{i}.npy')
          for i in range(2 if name == 'image_aligner' else 1)]


# --- the wire schema ------------------------------------------------------------

_KINDS = {1: 'double', 2: 'float', 3: 'int64', 4: 'uint64', 5: 'int32',
          6: 'fixed64', 7: 'fixed32', 8: 'bool', 9: 'string', 11: 'message',
          12: 'bytes', 13: 'uint32', 14: 'int32', 18: 'sint64'}


def test_tf_wire_fields_are_tensorflows():
  from google.protobuf import descriptor_pool
  from tensorflow.core.protobuf import saved_model_pb2  # noqa: F401
  from tensorflow.core.protobuf import tensor_bundle_pb2  # noqa: F401
  from tensorflow.core.protobuf import trackable_object_graph_pb2  # noqa: F401
  from tensorflow.compiler.xla import xla_data_pb2  # noqa: F401

  pool = descriptor_pool.Default()
  checked = 0
  for cls in tf_wire.MESSAGES:
    descriptor = pool.FindMessageTypeByName(cls.TF_NAME)
    for field in cls.FIELDS:
      tf_field = descriptor.fields_by_number[field.number]
      assert tf_field.name == field.name, (cls.TF_NAME, field)
      is_map = (tf_field.message_type is not None
                and tf_field.message_type.GetOptions().map_entry)
      if field.map_value is not None:
        assert is_map, (cls.TF_NAME, field.name)
        value = tf_field.message_type.fields_by_name['value']
        assert _KINDS[value.type] == field.map_value[0], field.name
        if field.map_value[1] is not None:
          assert value.message_type.full_name == field.map_value[1].TF_NAME
      else:
        assert _KINDS[tf_field.type] == field.kind, (cls.TF_NAME, field.name)
        assert (tf_field.label == tf_field.LABEL_REPEATED) == field.repeated
        if field.repeated and field.kind != 'message':
          assert tf_field.is_packed == field.packed, field.name
        if field.message is not None:
          assert tf_field.message_type.full_name == field.message.TF_NAME
      checked += 1
  assert checked > 150


@pytest.mark.parametrize('name', NAMES)
def test_tf_wire_reserializes_tensorflows_saved_model(name):
  data = (FIXTURES / name / 'saved_model' / 'saved_model.pb').read_bytes()
  saved = tf_wire.SavedModel.FromString(data)
  assert saved.SerializeToString() == data
  meta = saved.meta_graphs[0]
  assert sorted(meta.signature_def) == ['__saved_model_init_op',
                                        'serving_default']


# --- the tensor bundle ----------------------------------------------------------


@pytest.mark.parametrize('name', NAMES)
def test_tensor_bundle_rewrites_tensorflows_bytes(name, tmp_path):
  prefix = str(FIXTURES / name / 'saved_model' / 'variables' / 'variables')
  header, tensors = tensor_bundle.read_bundle(prefix)
  assert header.num_shards == 1 and list(tensors) == [
      '_CHECKPOINTABLE_OBJECT_GRAPH']
  out = str(tmp_path / 'variables')
  tensor_bundle.write_bundle(out, tensors)
  for suffix in ('.index', '.data-00000-of-00001'):
    assert (pathlib.Path(out + suffix).read_bytes()
            == pathlib.Path(prefix + suffix).read_bytes())


def test_tensor_bundle_numeric_tensors_cross_with_tensorflow(tmp_path):
  rng = np.random.default_rng(0)
  values = {'a/kernel': rng.standard_normal((3, 5)).astype(np.float32),
            'b': rng.integers(-9, 9, (7,)).astype(np.int64),
            'c': np.float64(2.5) * np.ones((2, 2))}
  ckpt = tf.train.Checkpoint(**{k.replace('/', '_'): tf.Variable(v)
                                for k, v in values.items()})
  path = ckpt.write(str(tmp_path / 'tf' / 'ckpt'))
  _, tensors = tensor_bundle.read_bundle(path)
  reader = tf.train.load_checkpoint(path)
  for key in reader.get_variable_to_shape_map():
    np.testing.assert_array_equal(tensors[key], reader.get_tensor(key))
  # Many keys: several restart points in a block.
  many = {f'var_{i:03d}': rng.standard_normal((i % 4 + 1,)).astype(
      np.float32) for i in range(40)}
  many['strings'] = [b'alpha', b'', b'gamma']
  out = str(tmp_path / 'port' / 'bundle')
  many['scalar'] = b'one string'
  tensor_bundle.write_bundle(out, many)
  reader = tf.train.load_checkpoint(out)
  for key, value in many.items():
    got = reader.get_tensor(key)
    if key in ('strings', 'scalar'):
      assert (list(got) if key == 'strings' else got) == value
    else:
      np.testing.assert_array_equal(got, value)
  _, back = tensor_bundle.read_bundle(out)
  assert back['strings'] == many['strings']
  assert back['scalar'] == many['scalar']


# --- the bytecode ---------------------------------------------------------------


def _mlir_text(data: bytes) -> str:
  ir = pytest.importorskip('jaxlib.mlir.ir')
  from jaxlib.mlir.dialects import chlo, stablehlo as mlir_stablehlo

  with ir.Context() as ctx:
    mlir_stablehlo.register_dialect(ctx)
    chlo.register_dialect(ctx)
    module = mlir_stablehlo.deserialize_portable_artifact(ctx, data)
    assert module.operation.verify()
    return module.operation.get_asm(enable_debug_info=True)


@pytest.mark.parametrize('name', NAMES)
def test_bytecode_reads_writes_and_reads_back_the_jax_fixtures(name):
  data = _module_bytes(name)
  module = mb.read_module(data)
  versions = json.loads((FIXTURES / 'versions.json').read_text())
  assert module.version == versions['mlir_bytecode']
  assert module.producer == versions['producer']
  rewritten = mb.write_module(module)
  assert mb.canonical(mb.read_module(rewritten)) == mb.canonical(module)
  assert _mlir_text(rewritten) == _mlir_text(data)


def test_bytecode_of_the_ports_exports_reads_back_equal():
  model = t_eval_agent.MLPPolicy(10, (16, 16), 3).eval()
  module, shapes, is_tuple = torch_to_stablehlo.export(model, (10,), 'cpu')
  assert shapes == [(3,)] and not is_tuple
  data = mb.write_module(module)
  assert mb.canonical(mb.read_module(data)) == mb.canonical(module)
  text = _mlir_text(data)
  assert 'jax.global_constant = "_platform_index"' in text
  assert 'stablehlo.dot_general' in text


def test_bytecode_refuses_versions_it_does_not_know():
  data = _module_bytes('mlp_policy')
  start = len(mb.MAGIC)
  newer = data[:start] + mb.encode_varint(7) + data[start + 1:]
  with pytest.raises(mb.BytecodeError, match='bytecode version 7'):
    mb.read_module(newer)
  producer = mb.read_module(data).producer.encode()
  future = data.replace(producer, b'StableHLO_v1.99.0', 1)
  with pytest.raises(mb.BytecodeError, match='VHLO version 1.99.0'):
    mb.read_module(future)
  sine = data.replace(b'tanh_v2', b'sine_v2')
  with pytest.raises(mb.BytecodeError, match='vhlo.sine_v2'):
    mb.read_module(sine)
  module = mb.read_module(data)
  module.producer = 'StableHLO_v2.0.0'
  with pytest.raises(mb.BytecodeError, match='VHLO version 2.0.0'):
    mb.write_module(module)


# --- the interpreter ------------------------------------------------------------


@pytest.mark.parametrize('name', NAMES)
def test_interpreter_gives_jaxs_recorded_outputs(name):
  program = stablehlo.load(_module_bytes(name), 'cpu')
  outputs = program(np.load(FIXTURES / name / 'input.npy'))
  rtol, atol = TOLERANCES[name]
  for got, want in zip(outputs, _outputs(name), strict=True):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_interpreter_refuses_an_unknown_op_by_name():
  module = mb.read_module(_module_bytes('mlp_policy'))
  func = module.root.regions[0].blocks[0].ops[0]
  tanh = next(op for op in func.regions[0].blocks[0].ops
              if op.name == 'vhlo.tanh_v2')
  tanh.name = 'vhlo.cosine_v2'
  with pytest.raises(stablehlo.UnsupportedOpError, match='vhlo.cosine_v2'):
    stablehlo.Program(module, 'cpu')


@pytest.mark.parametrize('prop', ['window_strides', 'rhs_dilation'])
def test_interpreter_refuses_lhs_dilated_convolutions_off_conv_transpose(
    prop):
  module = mb.read_module(_module_bytes('atom_detector'))

  def walk(op):
    yield op
    for region in op.regions:
      for block in region.blocks:
        for inner in block.ops:
          yield from walk(inner)

  convs = [op for op in walk(module.root)
           if op.name == 'vhlo.convolution_v1'
           and any(d != 1 for d in stablehlo.ints(op.props['lhs_dilation']))]
  assert convs
  stablehlo.Program(module, 'cpu')
  convs[0].props[prop] = convs[0].props['lhs_dilation']
  with pytest.raises(stablehlo.UnsupportedOpError,
                     match='lhs-dilated convolution with a window stride'):
    stablehlo.Program(module, 'cpu')


def test_interpreter_keeps_tf32_off_inside():
  torch.backends.cuda.matmul.allow_tf32 = True
  seen = []

  class Probe(torch.nn.Module):

    def forward(self, x):
      return x * 2.0

  module, _, _ = torch_to_stablehlo.export(Probe(), (2,), 'cpu')
  program = stablehlo.Program(module, 'cpu')
  original = program._run  # pylint: disable=protected-access

  def run(*args):
    seen.append(torch.backends.cuda.matmul.allow_tf32)
    return original(*args)

  program._run = run  # pylint: disable=protected-access
  index = np.int32(0)  # the platform index
  np.testing.assert_array_equal(
      program(index, np.ones(2, np.float32))[0].numpy(), [2.0, 2.0])
  assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False


def test_export_refuses_an_aten_op_missing_from_the_table():

  class Sorter(torch.nn.Module):

    def forward(self, x):
      return torch.sort(x).values

  with pytest.raises(torch_to_stablehlo.UnsupportedAtenOpError,
                     match='aten.sort'):
    torch_to_stablehlo.export(Sorter(), (4,), 'cpu')


# --- the loader -----------------------------------------------------------------


@pytest.mark.parametrize('name', NAMES)
def test_loader_runs_the_committed_jax_exports(name):
  model = t_tf_export.load_tf_saved_model(
      str(FIXTURES / name / 'saved_model'), device='cpu')
  x = np.load(FIXTURES / name / 'input.npy')
  out = model(x)
  outs = out if isinstance(out, tuple) else (out,)
  assert isinstance(out, tuple) == (name == 'image_aligner')
  signature = model.signatures['serving_default'](x)
  assert sorted(signature) == [f'output_{i}' for i in range(len(outs))]
  rtol, atol = TOLERANCES[name]
  for i, (got, want) in enumerate(zip(outs, _outputs(name), strict=True)):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    torch.testing.assert_close(signature[f'output_{i}'], got)


def test_loader_reads_variables_and_refuses_plain_tf_graphs(tmp_path):
  jax = pytest.importorskip('jax')
  from jax.experimental import jax2tf

  rng = np.random.default_rng(0)
  params = {'w': rng.standard_normal((4, 3)).astype(np.float32),
            'b': rng.standard_normal((3,)).astype(np.float32)}

  def apply(p, x):
    return jax.numpy.tanh(x @ p['w'] + p['b'])

  variables = {k: tf.Variable(v) for k, v in params.items()}
  module = tf.Module()
  module.params = variables
  converted = jax2tf.convert(apply, with_gradient=False)
  module.__call__ = tf.function(
      lambda x: converted(variables, x), autograph=False,
      input_signature=[tf.TensorSpec([2, 4], tf.float32, name='x')])
  tf.saved_model.save(module, str(tmp_path / 'with_vars'))
  x = rng.standard_normal((2, 4)).astype(np.float32)
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'with_vars'),
                                           device='cpu')
  np.testing.assert_allclose(loaded(x).numpy(),
                             np.tanh(x @ params['w'] + params['b']),
                             rtol=1e-5, atol=1e-6)

  plain = tf.Module()
  plain.w = tf.Variable(params['w'])
  plain.__call__ = tf.function(
      lambda x: tf.matmul(x, plain.w),
      input_signature=[tf.TensorSpec([2, 4], tf.float32)])
  tf.saved_model.save(plain, str(tmp_path / 'plain'))
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'plain'),
                                           device='cpu')
  # A graph of plain TF ops is no longer refused (the name is kept from
  # when it was): its MatMul computes x @ w.
  np.testing.assert_allclose(loaded(x).numpy(), x @ params['w'], rtol=1e-6,
                             atol=1e-6)


def _saved_graph(save_dir):
  with open(pathlib.Path(save_dir) / 'saved_model.pb', 'rb') as f:
    return tf_wire.SavedModel.FromString(f.read()).meta_graphs[0]


def test_export_with_gradient_has_jaxs_layout(tmp_path):
  """As jax2tf saves a gradient: the converted function's outputs and
  input pass an IdentityN whose `_gradient_op_type` the library registers
  to a gradient function; that function's XlaCallModule takes the captured
  input and one cotangent an output, and the object graph binds the
  capture."""
  jax = pytest.importorskip('jax')
  from putting_dune_tpu.io import tf_export as j_tf_export  # pylint: disable=g-import-not-at-top

  w = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)
  j_tf_export.export_tf_saved_model(
      jax.jit(lambda x: (jax.numpy.tanh(x @ w), x.sum())), (4, 3),
      str(tmp_path / 'jax'), with_gradient=True)

  def fn(x):
    return torch.tanh(x @ torch.from_numpy(w)), x.sum()

  t_tf_export.export_tf_saved_model(fn, (4, 3), str(tmp_path / 'port'),
                                    with_gradient=True)
  for tag in ('jax', 'port'):
    meta = _saved_graph(tmp_path / tag)
    library = meta.graph_def.library
    (registered,) = library.registered_gradients
    functions = {f.signature.name: f for f in library.function}
    converted = [f for f in functions.values()
                 if any(n.op == 'IdentityN' and '_gradient_op_type' in n.attr
                        for n in f.node_def)
                 and 'converted_fun' in f.signature.name]
    (identity_n,) = [n for n in converted[0].node_def if n.op == 'IdentityN']
    assert (identity_n.attr['_gradient_op_type'].s.decode()
            == registered.registered_op_type)
    assert len(identity_n.input) == 3  # two outputs and the input
    grad = functions[registered.gradient_func]
    assert [a.name for a in grad.signature.input_arg][:3] == [
        'result_grads_0', 'result_grads_1', 'result_grads_2']
    (call,) = [n for n in grad.node_def if n.op == 'XlaCallModule']
    assert len(call.input) == 3 and len(call.attr['Tout'].list.type) == 1
    concrete = meta.object_graph_def.concrete_functions[
        registered.gradient_func]
    (bound,) = concrete.bound_inputs
    capture = meta.object_graph_def.nodes[bound].captured_tensor
    assert capture.name == 'jax2tf_arg_0:0'
    assert capture.concrete_function == converted[0].signature.name
  x = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
  cotangents = [np.ones((4, 2), np.float32), np.float32(2.0)]
  for tag in ('jax', 'port'):
    np.testing.assert_allclose(
        torch_tf_checks.tf_gradient(tmp_path / tag, x, cotangents),
        torch_tf_checks.port_gradient(tmp_path / tag, x, cotangents),
        rtol=0, atol=1e-6)


class _Masked(torch.nn.Module):

  def __init__(self, mask):
    super().__init__()
    self.register_buffer('mask', torch.from_numpy(mask))

  def forward(self, x):
    return torch.where(self.mask, x, -x)


_RNG = np.random.default_rng(5)
# Under a byte (the byte 0x06, which is no splat), a whole byte of ones
# (0xff, MLIR's splat byte), and a few bytes.
MASKS = {'under_a_byte': np.array([False, True, True]),
         'a_byte_of_ones': np.ones(8, bool),
         'two_bytes': _RNG.random(12) < 0.5,
         'eight_bytes': _RNG.random(64) < 0.5}


@pytest.mark.parametrize('name', MASKS)
def test_bool_constants_read_as_tensorflow_reads_them(tmp_path, name):
  """A bool constant, a bool buffer in the port's export and a captured
  mask in JAX's: TF and the port's loader give the function's output on
  both exports."""
  jax = pytest.importorskip('jax')
  from putting_dune_tpu.io import tf_export as j_tf_export  # pylint: disable=g-import-not-at-top

  mask = MASKS[name]
  size = mask.size
  module = _Masked(mask)
  t_tf_export.export_tf_saved_model(module, (size,), str(tmp_path / 'port'))
  j_tf_export.export_tf_saved_model(
      jax.jit(lambda x: jax.numpy.where(mask, x, -x)), (size,),
      str(tmp_path / 'jax'))
  x = np.random.default_rng(size).standard_normal(size).astype(np.float32)
  want = module(torch.from_numpy(x)).numpy()
  for tag in ('port', 'jax'):
    np.testing.assert_array_equal(
        tf.saved_model.load(str(tmp_path / tag))(x).numpy(), want)
    np.testing.assert_array_equal(
        t_tf_export.load_tf_saved_model(str(tmp_path / tag), device='cpu')(
            torch.from_numpy(x)).numpy(), want)


def test_loader_without_a_gradient_stops_it(tmp_path):
  t_tf_export.export_tf_saved_model(lambda x: x * 2.0, (2,),
                                    str(tmp_path / 'g'))
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'g'), device='cpu')
  x = torch.ones(2, requires_grad=True)
  assert not loaded(x).requires_grad


@pytest.mark.parametrize('window,stride', [(2, 2), (3, 2), (3, 1)])
def test_loader_differentiates_jax_pooling_exports(tmp_path, window, stride):
  """JAX's VJP of max pooling (select_and_scatter, with the ties a ReLU
  makes, in overlapping windows too), a pad and a flip, run by the
  interpreter: jax.vjp's gradient."""
  jax = pytest.importorskip('jax')
  import flax.linen as nn  # pylint: disable=g-import-not-at-top
  from putting_dune_tpu.io import tf_export as j_tf_export  # pylint: disable=g-import-not-at-top

  jnp = jax.numpy

  def fn(x):
    y = nn.max_pool(jax.nn.relu(x), (window, window), (stride, stride))
    return jnp.flip(jnp.pad(y, ((0, 0), (1, 2), (0, 1), (0, 0))), axis=1)

  j_tf_export.export_tf_saved_model(jax.jit(fn), (1, 9, 9, 2),
                                    str(tmp_path / 'jax'), with_gradient=True)
  rng = np.random.default_rng(window * 10 + stride)
  x = rng.standard_normal((1, 9, 9, 2)).astype(np.float32)
  out, vjp = jax.vjp(fn, x)
  cotangent = rng.standard_normal(out.shape).astype(np.float32)
  (want,) = vjp(cotangent)
  np.testing.assert_allclose(
      torch_tf_checks.port_gradient(tmp_path / 'jax', x, [cotangent]),
      np.asarray(want), rtol=0, atol=1e-6)


def test_ports_export_loads_in_tensorflow_with_jaxs_structure(tmp_path):
  """The port's export has the JAX export's signature keys, input name,
  platforms and output structure, and TF computes what the port does:
  through `tf.saved_model.load`, and through the C++ loader that serving
  uses (the export has no saver_def or save/restore functions)."""
  model = t_eval_agent.MLPPolicy(10, (8,), 2).eval()
  t_tf_export.export_tf_saved_model(model, (10,), str(tmp_path / 'm'),
                                    input_name='observation')
  x = np.random.default_rng(1).standard_normal(10).astype(np.float32)
  loaded = tf.saved_model.load(str(tmp_path / 'm'))
  with torch.no_grad():
    want = model(torch.from_numpy(x)).numpy()
  np.testing.assert_allclose(loaded(x).numpy(), want, rtol=1e-5, atol=1e-6)
  signature = loaded.signatures['serving_default']
  assert list(signature.structured_input_signature[1]) == ['observation']
  assert sorted(signature(observation=tf.constant(x))) == ['output_0']
  np.testing.assert_allclose(
      torch_tf_checks.run_with_c_api(tmp_path / 'm',
                                     'serving_default_observation', x, (2,)),
      want, rtol=1e-5, atol=1e-6)
  with open(tmp_path / 'm' / 'saved_model.pb', 'rb') as f:
    saved = tf_wire.SavedModel.FromString(f.read())
  calls = [n for f in saved.meta_graphs[0].graph_def.library.function
           for n in f.node_def if n.op == 'XlaCallModule']
  assert [p for p in calls[0].attr['platforms'].list.s] == [b'CPU', b'CUDA']
  assert calls[0].attr['version'].i == 10


# --- the agent ------------------------------------------------------------------


class _TimeStep:

  def __init__(self, observation):
    self.observation = observation


def test_saved_model_agents_agree_action_for_action():
  jax = pytest.importorskip('jax')
  from putting_dune_tpu import run_helpers as j_run_helpers
  from putting_dune_tpu.agents import eval_agent as j_eval_agent
  from putting_dune_tpu.experiments import registry as j_registry

  path = str(FIXTURES / 'mlp_policy' / 'saved_model')
  port_agent = t_eval_agent.TfSavedModelAgent(path, device='cpu')
  jax_agent = j_eval_agent.TfSavedModelAgent(path)
  port_agent.set_mode('eval')
  for seed in range(3):
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (10,)),
                     np.float32)
    np.testing.assert_allclose(port_agent.step(_TimeStep(obs)),
                               jax_agent.step(_TimeStep(obs)),
                               rtol=1e-5, atol=1e-6)
  experiment = j_registry.create_eval_experiment('relative_random_simple')
  env = j_run_helpers.create_putting_dune_env(
      seed=0, get_adapters_and_goal=experiment.get_adapters_and_goal,
      get_simulator_config=experiment.get_simulator_config,
      simulator_step_limit=12, grid_columns=20)
  ts = env.reset()
  steps = 0
  while not ts.last() and steps < 12:
    a_port = port_agent.step(ts)
    a_jax = np.asarray(jax_agent.step(ts))
    assert isinstance(a_port, np.ndarray)
    np.testing.assert_allclose(a_port, a_jax, rtol=1e-5, atol=1e-6)
    ts = env.step(a_jax)
    steps += 1
  assert steps > 0
