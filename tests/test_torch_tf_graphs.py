"""SavedModels of TF ops, as jax2tf's pre-native path wrote them (the
reference's 2023 policies), read by the port's loader without TF.

  * every committed fixture of `tests/data/torch_tf_graphs`
    (`scripts/make_tf_graph_fixtures.py`: five models in the `xla` and
    `plain` modes) on the CPU against TF's recorded outputs, and against TF
    run now; the graphs hold TF ops and no `XlaCallModule`;
  * single ops outside the fixtures (masks of StridedSlice, SAME / VALID /
    EXPLICIT padding, a reducer that is no monoid, gathers, ...) against TF
    on small graphs saved here;
  * nested inputs: the port's `TfSavedModelAgent` on a dict observation
    against the JAX package's (before the repair the loader raised
    `TypeError: missing input 'obs'`), keyword and signature calls;
  * the full-width `ppo_simple_images_tf` and `230422_ppo_v3_2s` policies
    as graphs of TF ops in both modes against the JAX package's
    `EvalAgent`, within 1e-5;
  * gradients: plain-form graphs under autograd against TF's
    `GradientTape` on the same file, max|d| within 1e-4 of the gradient's
    scale;
  * an op outside the table refused, naming the op, its node and the file.

Tolerances (rtol, atol): 1e-5 for the MLPs and the actor-critic, (1e-5,
1e-6) for the rate predictor, and test_torch_tf_interop.py's (1e-3, 1e-4)
for the UNets.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from putting_dune_torch.agents import eval_agent as t_eval_agent
from putting_dune_torch.io import tf_export as t_tf_export
from putting_dune_torch.io import tf_ops
from putting_dune_torch.proto import tf_wire

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::FutureWarning',
                                        'ignore::DeprecationWarning')

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / 'tests' / 'data' / 'torch_tf_graphs'
INDEX = json.loads((FIXTURES / 'index.json').read_text())
NAMES = sorted(INDEX['fixtures'])
TOLERANCES = {'ppo_v3_2s': (1e-5, 1e-5), 'actor_critic': (1e-5, 1e-5),
              'rate_predictor': (1e-5, 1e-6),
              'atom_detector': (1e-3, 1e-4), 'image_aligner': (1e-3, 1e-4)}
WEIGHTS = pathlib.Path(t_eval_agent.MODEL_WEIGHTS_DIR)


def _model(name: str) -> str:
  return name.rsplit('_', 1)[0]


def _inputs(name: str):
  keys = INDEX['fixtures'][name]['inputs']
  if keys:
    return {k: np.load(FIXTURES / name / f'input_{k}.npy') for k in keys}
  return np.load(FIXTURES / name / 'input.npy')


def _outputs(name: str):
  return [np.load(FIXTURES / name / f'output_{i}.npy')
          for i in range(INDEX['fixtures'][name]['outputs'])]


def _flat(out):
  return list(out) if isinstance(out, (tuple, list)) else [out]


def _translator():
  sys.path.insert(0, str(REPO / 'scripts'))
  import make_tf_graph_fixtures  # pylint: disable=g-import-not-at-top

  return make_tf_graph_fixtures


# --- the committed fixtures -----------------------------------------------------


@pytest.mark.parametrize('name', NAMES)
def test_loader_gives_tensorflows_recorded_outputs(name):
  loaded = t_tf_export.load_tf_saved_model(
      str(FIXTURES / name / 'saved_model'), device='cpu')
  x = _inputs(name)
  got = _flat(loaded(x))
  rtol, atol = TOLERANCES[_model(name)]
  for g, want in zip(got, _outputs(name), strict=True):
    assert g.device.type == 'cpu' and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), want, rtol=rtol, atol=atol)
  # The serving signature takes the same inputs by keyword.
  kwargs = x if isinstance(x, dict) else {
      'input': x, 'image': x, 'beam_position': x}
  signature = loaded.signatures['serving_default']
  names = INDEX['fixtures'][name]['inputs'] or [
      {'ppo_v3_2s': 'input', 'rate_predictor': 'beam_position'}.get(
          _model(name), 'image')]
  out = signature(**{k: kwargs[k] for k in names})
  assert sorted(out) == [f'output_{i}' for i in range(len(got))]
  for i, g in enumerate(got):
    torch.testing.assert_close(out[f'output_{i}'], g)


@pytest.mark.parametrize('name', NAMES)
def test_loader_matches_tensorflow_run_now(name):
  tf = pytest.importorskip('tensorflow')
  x = _inputs(name)
  want = _flat(tf.saved_model.load(str(FIXTURES / name / 'saved_model'))(x))
  got = _flat(t_tf_export.load_tf_saved_model(
      str(FIXTURES / name / 'saved_model'), device='cpu')(x))
  rtol, atol = TOLERANCES[_model(name)]
  for g, w in zip(got, want, strict=True):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize('name', NAMES)
def test_fixtures_are_graphs_of_tf_ops(name):
  """No XlaCallModule; the `xla` mode's products are `Xla*` ops, the
  `plain` mode's none; every op the call reaches is in the table."""
  with open(FIXTURES / name / 'saved_model' / 'saved_model.pb', 'rb') as f:
    saved = tf_wire.SavedModel.FromString(f.read())
  library = {fn.signature.name: fn
             for fn in saved.meta_graphs[0].graph_def.library.function}
  call = [fn for n, fn in library.items() if n.startswith('__inference_call')]
  ops, stack = set(), list(call)
  while stack:
    fn = stack.pop()
    for node in fn.node_def:
      ops.add(node.op)
      for attr in node.attr.values():
        if attr.HasField('func') and attr.func.name in library:
          stack.append(library[attr.func.name])
  assert 'XlaCallModule' not in ops
  xla = {op for op in ops if op.startswith('Xla')}
  if name.endswith('_xla'):
    assert xla & {'XlaDotV2', 'XlaConvV2'}, ops
  else:
    assert not xla, xla
  structural = {'Const', 'ReadVariableOp', 'StatefulPartitionedCall',
                'PartitionedCall'}
  assert ops - structural <= set(tf_ops.OPS), ops - set(tf_ops.OPS)
  assert sorted(ops) == sorted(
      set(INDEX['fixtures'][name]['ops']) & ops)


# --- single ops ----------------------------------------------------------------


def _cases():
  """name -> (build(tf) -> fn of numpy inputs, inputs, jit_compile)."""
  rng = np.random.default_rng(7)
  img = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
  vec = rng.standard_normal((3, 4)).astype(np.float32)
  with_nan = vec.copy()
  with_nan[0, 1] = np.nan
  kernel = rng.standard_normal((3, 2, 3, 5)).astype(np.float32)
  grad_out = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)

  def conv(padding, strides=(1, 1), dilations=(1, 1), explicit=()):
    return lambda tf: lambda x: tf.raw_ops.Conv2D(
        input=x, filter=tf.constant(kernel), strides=[1, *strides, 1],
        padding=padding, explicit_paddings=list(explicit),
        dilations=[1, *dilations, 1])

  def xla(fn):
    from tensorflow.compiler.tf2xla.python import xla as tfxla  # pylint: disable=g-import-not-at-top
    return lambda tf: fn(tf, tfxla)

  def reduce_window(body):

    def build(tf, tfxla):
      spec = tf.TensorSpec((), tf.float32)
      reducer = tf.function(body(tf), autograph=False,
                            jit_compile=True).get_concrete_function(spec, spec)
      return lambda x: tfxla.reduce_window(
          x, tf.constant(1.0), reducer, window_dimensions=(1, 3, 2, 1),
          window_strides=(1, 2, 1, 1), padding=((0, 0), (1, 1), (0, 1),
                                                (0, 0)))

    return xla(build)

  def gather(tf, tfxla):
    from tensorflow.compiler.xla import xla_data_pb2  # pylint: disable=g-import-not-at-top
    numbers = xla_data_pb2.GatherDimensionNumbers(
        offset_dims=[1], collapsed_slice_dims=[0], start_index_map=[0],
        index_vector_dim=1)
    return lambda x: tfxla.gather(x, tf.constant([[2], [0], [5]]), numbers,
                                  slice_sizes=[1, 4])

  return {
      'erf_sqrt_relu': (lambda tf: lambda x: tf.raw_ops.Erf(x=x)
                        + tf.raw_ops.Sqrt(x=tf.raw_ops.Relu(features=x)),
                        [vec], False),
      'compare_isnan': (lambda tf: lambda x: tf.raw_ops.SelectV2(
          condition=tf.raw_ops.LogicalOr(
              x=tf.raw_ops.IsNan(x=x), y=tf.raw_ops.Less(x=x, y=0.5)),
          t=tf.raw_ops.Minimum(x=x, y=0.25), e=x), [with_nan], False),
      'equal_greater_cast': (lambda tf: lambda x: tf.raw_ops.Cast(
          x=tf.raw_ops.Equal(x=tf.raw_ops.Greater(x=x, y=0.0),
                             y=tf.constant(True)), DstT=tf.float32),
                             [vec], False),
      'shape_ops': (lambda tf: lambda x: tf.raw_ops.Pack(values=[
          tf.raw_ops.Squeeze(input=tf.raw_ops.ExpandDims(
              input=tf.raw_ops.Transpose(x=x, perm=[1, 0]), axis=-1),
                             axis=[2]),
          tf.raw_ops.Transpose(x=tf.raw_ops.Mean(input=x, axis=[1],
                                                 keep_dims=True),
                               perm=[1, 0]) * tf.ones((4, 3))], axis=-1),
                    [vec], False),
      'shape_fill_range': (lambda tf: lambda x: x * tf.raw_ops.Cast(
          x=tf.raw_ops.Range(start=0, limit=4, delta=1), DstT=tf.float32)
          + tf.raw_ops.Fill(dims=tf.raw_ops.Shape(input=x), value=2.0),
                           [vec], False),
      'strided_slice_masks': (lambda tf: lambda x: tf.raw_ops.StridedSlice(
          input=x, begin=[0, 5, 0], end=[0, 1, 0], strides=[1, -2, 1],
          begin_mask=0, end_mask=0, ellipsis_mask=4, new_axis_mask=0,
          shrink_axis_mask=1) + x[1, 1:8:3, ::-1][:2] + x[0, None, -3:-1,
                                                         ..., 0][0, :, :,
                                                                 None],
                              [img], False),
      'conv_same_strided': (conv('SAME', (2, 2)), [img], False),
      'conv_valid_dilated': (conv('VALID', (1, 1), (2, 2)), [img], False),
      'conv_explicit': (conv('EXPLICIT', (2, 1), (1, 1),
                             (0, 0, 2, 0, 1, 3, 0, 0)), [img], False),
      'conv_backprop_input_same': (lambda tf: lambda dy: (
          tf.raw_ops.Conv2DBackpropInput(
              input_sizes=[2, 17, 21, 3], filter=tf.constant(kernel),
              out_backprop=dy, strides=[1, 2, 2, 1], padding='SAME')),
                                   [grad_out], False),
      'bias_add_max_pool': (lambda tf: lambda x: tf.raw_ops.MaxPool(
          input=tf.raw_ops.BiasAdd(value=x, bias=[0.5, -1.0, 2.0]),
          ksize=[1, 3, 2, 1], strides=[1, 2, 2, 1], padding='SAME'),
                            [img], False),
      'matmuls_einsum': (lambda tf: lambda x: tf.raw_ops.MatMul(
          a=x, b=x, transpose_a=True) + tf.raw_ops.Einsum(
              inputs=[tf.raw_ops.BatchMatMulV2(
                  x=tf.reshape(x, (3, 4, 1)), y=tf.reshape(x, (3, 4, 1)),
                  adj_y=True)], equation='bij->ji'), [vec], False),
      'pad_gather_v2': (lambda tf: lambda x: tf.raw_ops.GatherV2(
          params=tf.raw_ops.PadV2(input=x, paddings=[[1, 0], [0, 2]],
                                  constant_values=-3.0),
          indices=[[3, 0], [1, 1]], axis=1) + tf.raw_ops.Pad(
              input=x, paddings=[[0, 1], [0, 0]])[:, :1, None], [vec], False),
      'xla_pad_dynamic_slice': (xla(lambda tf, tfxla: lambda x: (
          tfxla.dynamic_slice(
              tfxla.pad(x, tf.constant(-1.0), [1, -1], [2, 0], [1, 0]),
              [7, 1], [3, 2]))), [vec], True),
      'xla_gather': (xla(gather), [vec], True),
      'xla_conv_and_dot_v1': (xla(lambda tf, tfxla: lambda x: tfxla.dot_general(
          tf.reshape(tfxla.conv(
              x, tf.constant(kernel), window_strides=[1, 2], padding=[[1, 1],
                                                                      [0, 0]],
              lhs_dilation=[1, 1], rhs_dilation=[1, 1],
              dimension_numbers=_nhwc_numbers()), (-1, 5)),
          tf.constant(kernel[0, 0, :, :].T), _dot_numbers())), [img], True),
      'xla_reduce_window_min': (reduce_window(
          lambda tf: lambda a, b: tf.raw_ops.Minimum(x=b, y=a)), [img], True),
      'xla_reduce_window_not_a_monoid': (reduce_window(
          lambda tf: lambda a, b: tf.raw_ops.Mul(x=a, y=tf.tanh(b))),
                                         [img], True),
  }


def _nhwc_numbers():
  from tensorflow.compiler.xla import xla_data_pb2  # pylint: disable=g-import-not-at-top
  return xla_data_pb2.ConvolutionDimensionNumbers(
      input_batch_dimension=0, input_feature_dimension=3,
      input_spatial_dimensions=[1, 2], kernel_input_feature_dimension=2,
      kernel_output_feature_dimension=3, kernel_spatial_dimensions=[0, 1],
      output_batch_dimension=0, output_feature_dimension=3,
      output_spatial_dimensions=[1, 2])


def _dot_numbers():
  from tensorflow.compiler.xla import xla_data_pb2  # pylint: disable=g-import-not-at-top
  return xla_data_pb2.DotDimensionNumbers(lhs_contracting_dimensions=[1],
                                          rhs_contracting_dimensions=[0])


CASES = _cases()


def _save(tf, fn, inputs, path, jit_compile=False):
  module = tf.Module()
  module.__call__ = tf.function(
      fn, autograph=False, jit_compile=jit_compile,
      input_signature=[tf.TensorSpec(x.shape, tf.float32) for x in inputs])
  tf.saved_model.save(module, str(path))


@pytest.mark.parametrize('case', sorted(CASES))
def test_single_ops_against_tensorflow(case, tmp_path):
  tf = pytest.importorskip('tensorflow')
  build, inputs, jit_compile = CASES[case]
  _save(tf, build(tf), inputs, tmp_path / case, jit_compile)
  want = tf.saved_model.load(str(tmp_path / case))(*inputs)
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / case),
                                           device='cpu')
  got = loaded(*inputs)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6, equal_nan=True)


# --- nested inputs --------------------------------------------------------------


class _TimeStep:

  def __init__(self, observation):
    self.observation = observation


def test_dict_input_repair(tmp_path):
  """The issue's fault: a `__call__` of a dict, which the loader refused
  with `TypeError: missing input 'obs'`."""
  tf = pytest.importorskip('tensorflow')
  module = tf.Module()
  module.__call__ = tf.function(
      lambda obs: tf.identity(obs['goal_delta_angstroms']),
      input_signature=[{
          'image': tf.TensorSpec((1, 8, 8, 1), tf.float32, name='image'),
          'goal_delta_angstroms': tf.TensorSpec(
              (1, 2), tf.float32, name='goal_delta_angstroms')}])
  tf.saved_model.save(module, str(tmp_path / 'm'))
  obs = {'image': np.zeros((1, 8, 8, 1), np.float32),
         'goal_delta_angstroms': np.ones((1, 2), np.float32)}
  want = tf.saved_model.load(str(tmp_path / 'm'))(obs).numpy()
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'm'), device='cpu')
  np.testing.assert_array_equal(loaded(obs).numpy(), want)
  np.testing.assert_array_equal(loaded(obs=obs).numpy(), want)
  # The serving signature keeps its keyword inputs.
  (key,) = loaded.signatures['serving_default'](**obs)
  np.testing.assert_array_equal(
      loaded.signatures['serving_default'](**obs)[key].numpy(), want)
  with pytest.raises(TypeError, match='goal_delta_angstroms'):
    loaded({'image': obs['image']})
  with pytest.raises(TypeError, match='missing input'):
    loaded()


def test_tuple_and_list_inputs(tmp_path):
  tf = pytest.importorskip('tensorflow')
  module = tf.Module()
  module.__call__ = tf.function(
      lambda pair, scale: (pair[0] * scale[1], pair[1] - scale[0]),
      input_signature=[(tf.TensorSpec((3,), tf.float32),
                        tf.TensorSpec((3,), tf.float32)),
                       [tf.TensorSpec((), tf.float32),
                        tf.TensorSpec((), tf.float32)]])
  tf.saved_model.save(module, str(tmp_path / 'm'))
  pair = (np.arange(3, dtype=np.float32), np.ones(3, np.float32))
  scale = [np.float32(2.0), np.float32(3.0)]
  want = tf.saved_model.load(str(tmp_path / 'm'))(pair, scale)
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'm'), device='cpu')
  for got in (loaded(pair, scale), loaded(pair, scale=scale)):
    assert isinstance(got, tuple)
    for g, w in zip(got, want, strict=True):
      np.testing.assert_array_equal(g.numpy(), w.numpy())
  with pytest.raises(TypeError, match='sequence of 2'):
    loaded(pair[:1], scale)


@pytest.mark.parametrize('mode', ['xla', 'plain'])
def test_saved_model_agents_agree_on_a_dict_observation(mode):
  """The port's TfSavedModelAgent against the JAX package's on the narrow
  actor-critic's dict observation."""
  pytest.importorskip('tensorflow')
  from putting_dune_tpu.agents import eval_agent as j_eval_agent  # pylint: disable=g-import-not-at-top

  path = str(FIXTURES / f'actor_critic_{mode}' / 'saved_model')
  port_agent = t_eval_agent.TfSavedModelAgent(path, device='cpu')
  jax_agent = j_eval_agent.TfSavedModelAgent(path)
  rng = np.random.default_rng(11)
  for _ in range(3):
    obs = {'image': rng.random((128, 128, 1)).astype(np.float32),
           'goal_delta_angstroms': rng.standard_normal(2).astype(np.float32)}
    got = port_agent.step(_TimeStep(obs))
    assert isinstance(got, np.ndarray) and got.shape == (2,)
    np.testing.assert_allclose(got, jax_agent.step(_TimeStep(obs)),
                               rtol=1e-5, atol=1e-5)


# --- the shipped policies at full width ------------------------------------------


def _jax_eval_agent(name):
  pytest.importorskip('jax')
  from putting_dune_tpu.agents import eval_agent as j_eval_agent  # pylint: disable=g-import-not-at-top

  return j_eval_agent.EvalAgent.load(str(WEIGHTS / name))


@pytest.mark.parametrize('mode', ['xla', 'plain'])
def test_full_width_pixel_policy_as_tf_ops(mode, tmp_path):
  """`ppo_simple_images_tf` (4.3M parameters) written as a graph of TF
  ops from the shipped checkpoint: its actions are EvalAgent's."""
  pytest.importorskip('tensorflow')
  import jax  # pylint: disable=g-import-not-at-top

  agent = _jax_eval_agent('ppo_simple_images_tf')
  module = agent._module  # pylint: disable=protected-access

  def fn(params, obs):
    return module.apply({'params': params},
                        jax.tree_util.tree_map(lambda v: v[None], obs))[0]

  example = {'image': np.zeros((128, 128, 1), np.float32),
             'goal_delta_angstroms': np.zeros((2,), np.float32)}
  save_dir = tmp_path / mode
  _translator().write_policy(fn, agent.params, example, str(save_dir), mode)
  port_agent = t_eval_agent.TfSavedModelAgent(str(save_dir), device='cpu')
  rng = np.random.default_rng(3)
  for _ in range(3):
    obs = {'image': rng.random((128, 128, 1)).astype(np.float32),
           'goal_delta_angstroms': 3 * rng.standard_normal(2).astype(
               np.float32)}
    np.testing.assert_allclose(port_agent.step(_TimeStep(obs)),
                               agent.step(_TimeStep(obs)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('mode', ['xla', 'plain'])
def test_full_width_mlp_policy_fixture_is_eval_agents(mode):
  """The committed `230422_ppo_v3_2s` graphs (hidden (256, 256)) act as
  EvalAgent on the shipped checkpoint."""
  agent = _jax_eval_agent('230422_ppo_v3_2s')
  port_agent = t_eval_agent.TfSavedModelAgent(
      str(FIXTURES / f'ppo_v3_2s_{mode}' / 'saved_model'), device='cpu')
  dim = np.load(FIXTURES / f'ppo_v3_2s_{mode}' / 'input.npy').shape[0]
  rng = np.random.default_rng(4)
  for _ in range(5):
    obs = rng.standard_normal(dim).astype(np.float32)
    np.testing.assert_allclose(port_agent.step(_TimeStep(obs)),
                               agent.step(_TimeStep(obs)), rtol=1e-5,
                               atol=1e-5)


# --- gradients -------------------------------------------------------------------


def _tape_gradient(tf, path, x, cotangent):
  loaded = tf.saved_model.load(str(path))
  x = tf.constant(x)
  with tf.GradientTape() as tape:
    tape.watch(x)
    y = loaded(x)
  y = y[0] if isinstance(y, tuple) else y
  return tape.gradient(y, x, output_gradients=tf.constant(cotangent)).numpy()


def _port_gradient(path, x, cotangent):
  loaded = t_tf_export.load_tf_saved_model(str(path), device='cpu')
  x = torch.tensor(x, requires_grad=True)
  y = loaded(x)
  y = y[0] if isinstance(y, tuple) else y
  y.backward(torch.as_tensor(cotangent))
  return x.grad.numpy()


@pytest.mark.parametrize('model', ['ppo_v3_2s', 'atom_detector',
                                   'image_aligner', 'rate_predictor'])
def test_plain_graphs_differentiate_as_gradient_tape(model):
  """The input gradient of a plain-form fixture (the rate predictor's
  passes a StopGradient) under autograd: the tape's, max|d| within 1e-4
  of the gradient's scale, max(1, max|tape's|) (float32 sums of the
  UNets' backward differ by ~1e-5 of it between TF's kernels and
  torch's)."""
  tf = pytest.importorskip('tensorflow')
  name = f'{model}_plain'
  x = _inputs(name)
  cotangent = np.random.default_rng(9).standard_normal(
      _outputs(name)[0].shape).astype(np.float32)
  path = FIXTURES / name / 'saved_model'
  want = _tape_gradient(tf, path, x, cotangent)
  got = _port_gradient(path, x, cotangent)
  scale = max(1.0, float(np.abs(want).max()))
  assert np.abs(want).max() > 0 and got.shape == want.shape
  assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_stop_gradient_detaches(tmp_path):
  tf = pytest.importorskip('tensorflow')
  x = np.linspace(-1, 1, 5).astype(np.float32)
  _save(tf, lambda v: tf.raw_ops.StopGradient(input=v * v) * v, [x],
        tmp_path / 'm')
  cotangent = np.ones(5, np.float32)
  got = _port_gradient(tmp_path / 'm', x, cotangent)
  np.testing.assert_allclose(got, x * x, rtol=1e-6)
  np.testing.assert_allclose(
      got, _tape_gradient(tf, tmp_path / 'm', x, cotangent), rtol=1e-6)


def test_a_deep_graph_runs(tmp_path):
  """A chain of 3000 nodes: the loader schedules a function's nodes
  without recursion."""
  tf = pytest.importorskip('tensorflow')

  def chain(v):
    for _ in range(1500):
      v = tf.raw_ops.AddV2(x=tf.raw_ops.Mul(x=v, y=0.999), y=0.001)
    return v

  x = np.linspace(-1, 1, 4).astype(np.float32)
  _save(tf, chain, [x], tmp_path / 'm')
  want = tf.saved_model.load(str(tmp_path / 'm'))(x).numpy()
  got = t_tf_export.load_tf_saved_model(str(tmp_path / 'm'),
                                        device='cpu')(x).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_a_keras_export_runs(tmp_path):
  """What Keras's `model.export` writes for Conv2D, MaxPooling2D, Flatten
  and Dense layers (BiasAdd, Relu, MaxPool, MatMul and the variables of
  the layers) runs through the table."""
  tf = pytest.importorskip('tensorflow')
  tf.keras.utils.set_random_seed(1)
  model = tf.keras.Sequential([
      tf.keras.layers.Input((8, 8, 1)),
      tf.keras.layers.Conv2D(4, 3, padding='same', activation='relu'),
      tf.keras.layers.MaxPooling2D(), tf.keras.layers.Flatten(),
      tf.keras.layers.Dense(3)])
  model.export(str(tmp_path / 'm'), verbose=False)
  x = np.random.default_rng(0).standard_normal((2, 8, 8, 1)).astype(
      np.float32)
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'm'),
                                           device='cpu')
  (got,) = loaded.signatures['serving_default'](x).values()
  np.testing.assert_allclose(got.numpy(), model(x).numpy(), rtol=1e-5,
                             atol=1e-6)


# --- refusals --------------------------------------------------------------------


def test_an_op_outside_the_table_is_refused_by_name(tmp_path):
  """Names the op, the node and the file."""
  save_dir = tmp_path / 'saved_model'
  shutil.copytree(FIXTURES / 'ppo_v3_2s_plain' / 'saved_model', save_dir)
  path = save_dir / 'saved_model.pb'
  saved = tf_wire.SavedModel.FromString(path.read_bytes())
  (node,) = [n for fn in saved.meta_graphs[0].graph_def.library.function
             for n in fn.node_def if n.op == 'Tanh'][:1]
  node.op = 'Cosh'
  path.write_bytes(saved.SerializeToString())
  loaded = t_tf_export.load_tf_saved_model(str(save_dir), device='cpu')
  with pytest.raises(t_tf_export.UnsupportedGraphError) as info:
    loaded(_inputs('ppo_v3_2s_plain'))
  message = str(info.value)
  assert 'Cosh' in message and repr(node.name) in message
  assert str(save_dir) in message


def test_unsupported_attrs_name_the_node_and_the_file(tmp_path):
  tf = pytest.importorskip('tensorflow')
  x = np.ones((2, 3), np.float32)
  _save(tf, lambda v: tf.raw_ops.GatherV2(params=v, indices=[[0], [1]],
                                         axis=1, batch_dims=1), [x],
        tmp_path / 'm')
  loaded = t_tf_export.load_tf_saved_model(str(tmp_path / 'm'), device='cpu')
  with pytest.raises(t_tf_export.UnsupportedGraphError,
                     match=r"m: node 'GatherV2' \(GatherV2\): GatherV2 with "
                     'batch_dims'):
    loaded(x)
