"""Writes SavedModels of TF ops, as jax2tf's pre-native path wrote them, that
the port's SavedModel loader (`putting_dune_torch/io/tf_ops.py`) is held to
on the CPU and on the card (whose machine has neither JAX nor TensorFlow).

  python scripts/make_tf_graph_fixtures.py [--out_dir=tests/data]

The reference's `ppo_*` policies were exported in 2023 by
`jax2tf.convert` before native serialization was its default: their
graphs are TF ops (`XlaConvV2`, `XlaDotV2`, `AddV2`, `Tanh`, ...), not one
`XlaCallModule`. jax 0.9's jax2tf writes only `XlaCallModule`s, so this
script translates a model's jaxpr itself, primitive by primitive, the way
the pre-native path did, in one of its two modes:

  * `xla` (jax2tf's `enable_xla=True`, its default): convolutions, products
    and windows as `XlaConvV2`, `XlaDotV2` and `XlaReduceWindow` (a
    `Maximum` reducer function), in a `jit_compile` function;
  * `plain` (`enable_xla=False`): `Conv2D`, `Conv2DBackpropInput` for an
    lhs-dilated convolution, `MatMul` / `BatchMatMulV2` / `Einsum`,
    `MaxPool`, `StridedSlice`.

Both modes share the elementwise and shape ops (`AddV2`, `Mul`, `Tanh`,
`Reshape` + `BroadcastTo`, `ConcatV2`, ...). Only the equations the
outputs need are translated, and `jit` / `custom_jvp_call` are inlined.
The weights are `tf.Variable`s, so they land in `variables/`.

`torch_tf_graphs/<name>_<mode>/` holds `saved_model/` (`fingerprint.pb`
dropped), the seeded input (`input.npy`, or `input_<key>.npy` for a dict
observation) and TF's outputs on it (`output_<i>.npy`), for

  * `ppo_v3_2s`: the shipped `230422_ppo_v3_2s` MLP policy at full width
    (hidden (256, 256), action dim 3) on one observation;
  * `actor_critic`: the pixel ActorCritic's mean (conv features (4, 6, 8),
    hidden (16, 16)) on the env's unbatched {image (128, 128, 1),
    goal_delta_angstroms (2,)} observation;
  * `atom_detector`: the UNet at features (4, 8) on (1, 32, 32, 1);
  * `image_aligner`: the GlobalLocalUNet at features (4, 8) on
    (1, 32, 32, 3), returning (local, global);
  * `rate_predictor`: a two-model LearnedRatePredictor (16, 16) on (1, 4).

The script asserts that TF's outputs equal JAX's (jitted, on the CPU)
within 1e-5 (rtol and atol) before it writes them. `index.json` records
the JAX and TF versions, and for each fixture its input keys and the TF
ops of its graphs. `ppo_simple_images_tf` at full width (17 MB a mode) is
not committed: `write_policy` builds it where a test asks.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODES = ('xla', 'plain')
TOLERANCE = 1e-5


# --- the translator ----------------------------------------------------------


def _live(jaxpr):
  """The equations the outputs need, in order."""
  needed = {id(v) for v in jaxpr.outvars if not _is_literal(v)}
  live = []
  for eqn in reversed(jaxpr.eqns):
    if any(id(v) in needed for v in eqn.outvars):
      live.append(eqn)
      needed.update(id(v) for v in eqn.invars if not _is_literal(v))
  return live[::-1]


def _is_literal(v) -> bool:
  return type(v).__name__ == 'Literal'


class Translator:
  """Emits the TF ops of a jaxpr into the graph being traced."""

  def __init__(self, mode: str):
    import tensorflow as tf

    if mode not in MODES:
      raise ValueError(f'mode {mode!r} is not one of {MODES}')
    self.mode = mode
    self.tf = tf
    self._max_reducer = None

  def __call__(self, closed_jaxpr, args):
    return self.run(closed_jaxpr.jaxpr, closed_jaxpr.consts, args)

  def run(self, jaxpr, consts, args):
    tf = self.tf
    env = {}
    for v, c in zip(jaxpr.constvars, consts):
      env[id(v)] = tf.constant(np.asarray(c))
    for v, a in zip(jaxpr.invars, args):
      env[id(v)] = a

    def read(v):
      if _is_literal(v):
        return tf.constant(np.asarray(v.val, dtype=v.aval.dtype))
      return env[id(v)]

    for eqn in _live(jaxpr):
      ins = [read(v) for v in eqn.invars]
      outs = self.rule(eqn, ins)
      for v, out in zip(eqn.outvars, outs):
        out.set_shape(v.aval.shape)  # the static shape, for later rules
        env[id(v)] = out
    return [read(v) for v in jaxpr.outvars]

  def rule(self, eqn, ins):
    name = eqn.primitive.name
    params = eqn.params
    raw = self.tf.raw_ops
    if name in ('jit', 'pjit'):
      closed = params['jaxpr']
      return self.run(closed.jaxpr, closed.consts, ins)
    if name == 'custom_jvp_call':
      closed = params['call_jaxpr']
      return self.run(closed.jaxpr, closed.consts, ins)
    binary = {'add': raw.AddV2, 'sub': raw.Sub, 'mul': raw.Mul,
              'div': raw.RealDiv, 'max': raw.Maximum, 'min': raw.Minimum,
              'ne': raw.NotEqual, 'eq': raw.Equal, 'lt': raw.Less,
              'gt': raw.Greater}
    if name in binary:
      return [binary[name](x=ins[0], y=ins[1])]
    unary = {'neg': raw.Neg, 'abs': raw.Abs, 'square': raw.Square,
             'rsqrt': raw.Rsqrt, 'sqrt': raw.Sqrt, 'tanh': raw.Tanh,
             'exp': raw.Exp, 'log1p': raw.Log1p, 'logistic': raw.Sigmoid,
             'erf': raw.Erf, 'stop_gradient': raw.StopGradient}
    if name in unary:
      return [unary[name](x=ins[0]) if name != 'stop_gradient'
              else raw.StopGradient(input=ins[0])]
    out_aval = eqn.outvars[0].aval
    if name == 'integer_pow':
      return [self._integer_pow(ins[0], params['y'])]
    if name == 'select_n':
      if len(ins) != 3 or ins[0].dtype != self.tf.bool:
        raise NotImplementedError('select_n of more than two cases')
      return [raw.SelectV2(condition=ins[0], t=ins[2], e=ins[1])]
    if name == 'convert_element_type':
      return [raw.Cast(x=ins[0], DstT=self.tf.as_dtype(params['new_dtype']))]
    if name == 'broadcast_in_dim':
      return [self._broadcast_in_dim(ins[0], params['shape'],
                                     params['broadcast_dimensions'])]
    if name in ('reshape', 'squeeze'):
      return [raw.Reshape(tensor=ins[0], shape=self._ints(out_aval.shape))]
    if name == 'slice':
      return [self._slice(ins[0], params)]
    if name == 'concatenate':
      return [raw.ConcatV2(values=ins, axis=self._int(params['dimension']))]
    if name == 'transpose':
      return [raw.Transpose(x=ins[0], perm=self._ints(params['permutation']))]
    if name in ('reduce_sum', 'reduce_max'):
      op = {'reduce_sum': raw.Sum, 'reduce_max': raw.Max}[name]
      return [op(input=ins[0], axis=self._ints(params['axes']),
                 keep_dims=False)]
    if name == 'dot_general':
      return [self._dot_general(ins[0], ins[1], params)]
    if name == 'conv_general_dilated':
      return [self._conv(ins[0], ins[1], params, out_aval)]
    if name == 'reduce_window_max':
      return [self._max_window(ins[0], params)]
    if name == 'copy':
      return [raw.Identity(input=ins[0])]
    raise NotImplementedError(f'primitive {name}')

  # -- helpers ----------------------------------------------------------------

  def _ints(self, values):
    return self.tf.constant(np.asarray(values, np.int32).reshape(-1))

  def _int(self, value):
    return self.tf.constant(np.int32(value))

  def _integer_pow(self, x, y):
    """Square and multiply, as XLA's lowering of integer_pow does."""
    raw = self.tf.raw_ops
    if y <= 0:
      raise NotImplementedError(f'integer_pow {y}')
    n, acc = y, None
    while n:
      if n & 1:
        acc = x if acc is None else raw.Mul(x=acc, y=x)
      n >>= 1
      if n:
        x = raw.Mul(x=x, y=x)
    return acc

  def _broadcast_in_dim(self, x, shape, dims):
    raw = self.tf.raw_ops
    order = sorted(range(len(dims)), key=lambda i: dims[i])
    if order != list(range(len(dims))):
      x = raw.Transpose(x=x, perm=self._ints(order))
    view = [1] * len(shape)
    for j, d in enumerate(sorted(dims)):
      view[d] = int(x.shape[j])
    x = raw.Reshape(tensor=x, shape=self._ints(view))
    return raw.BroadcastTo(input=x, shape=self._ints(shape))

  def _slice(self, x, params):
    raw = self.tf.raw_ops
    start, limit = params['start_indices'], params['limit_indices']
    strides = params['strides'] or (1,) * len(start)
    if self.mode == 'xla' and all(s == 1 for s in strides):
      return raw.Slice(input=x, begin=self._ints(start),
                       size=self._ints([l - s for s, l in zip(start, limit)]))
    return raw.StridedSlice(input=x, begin=self._ints(start),
                            end=self._ints(limit), strides=self._ints(strides))

  def _dot_general(self, a, b, params):
    from tensorflow.compiler.tf2xla.python import xla as tfxla

    raw = self.tf.raw_ops
    (lc, rc), (lb, rb) = params['dimension_numbers']
    lc, rc, lb, rb = (tuple(int(d) for d in v) for v in (lc, rc, lb, rb))
    if self.mode == 'xla':
      numbers = tfxla.DotDimensionNumbers()
      numbers.lhs_contracting_dimensions.extend(lc)
      numbers.rhs_contracting_dimensions.extend(rc)
      numbers.lhs_batch_dimensions.extend(lb)
      numbers.rhs_batch_dimensions.extend(rb)
      return tfxla.dot_general(a, b, numbers, use_v2=True,
                               preferred_element_type=a.dtype)
    ra, rb_rank = len(a.shape), len(b.shape)
    if not lb and ra == 2 and rb_rank == 2 and lc == (1,) and rc in ((0,),
                                                                    (1,)):
      return raw.MatMul(a=a, b=b, transpose_b=rc == (1,))
    nb = len(lb)
    if (nb and lb == rb == tuple(range(nb)) and ra == rb_rank == nb + 2
        and lc == (nb + 1,) and rc == (nb,)):
      return raw.BatchMatMulV2(x=a, y=b)
    letters = iter('abcdefghijklmnopqrstuvwxyz')
    la = [next(letters) for _ in range(ra)]
    lb_letters = [None] * rb_rank
    for i, j in zip(lb, rb):
      lb_letters[j] = la[i]
    for i, j in zip(lc, rc):
      lb_letters[j] = la[i]
    lb_letters = [c or next(letters) for c in lb_letters]
    out = ([la[i] for i in lb] + [la[i] for i in range(ra)
                                  if i not in lb + lc]
           + [lb_letters[j] for j in range(rb_rank) if j not in rb + rc])
    equation = f"{''.join(la)},{''.join(lb_letters)}->{''.join(out)}"
    return raw.Einsum(inputs=[a, b], equation=equation)

  def _conv(self, x, w, params, out_aval):
    from tensorflow.compiler.tf2xla.python import xla as tfxla

    numbers = params['dimension_numbers']
    lhs, rhs, out = numbers.lhs_spec, numbers.rhs_spec, numbers.out_spec
    strides = tuple(params['window_strides'])
    padding = [tuple(p) for p in params['padding']]
    lhs_dil = tuple(params['lhs_dilation'])
    rhs_dil = tuple(params['rhs_dilation'])
    groups = params['feature_group_count']
    if params['batch_group_count'] != 1:
      raise NotImplementedError('batch_group_count')
    if self.mode == 'xla':
      proto = tfxla.xla_data_pb2.ConvolutionDimensionNumbers(
          input_batch_dimension=lhs[0], input_feature_dimension=lhs[1],
          input_spatial_dimensions=lhs[2:],
          kernel_output_feature_dimension=rhs[0],
          kernel_input_feature_dimension=rhs[1],
          kernel_spatial_dimensions=rhs[2:],
          output_batch_dimension=out[0], output_feature_dimension=out[1],
          output_spatial_dimensions=out[2:])
      return tfxla.conv(
          x, w, window_strides=self._ints(strides),
          padding=self.tf.constant(np.asarray(padding, np.int32)),
          lhs_dilation=self._ints(lhs_dil), rhs_dilation=self._ints(rhs_dil),
          dimension_numbers=proto, feature_group_count=self._int(groups),
          use_v2=True, preferred_element_type=x.dtype)
    if (tuple(lhs), tuple(rhs), tuple(out)) != ((0, 3, 1, 2), (3, 2, 0, 1),
                                                (0, 3, 1, 2)):
      raise NotImplementedError(f'a plain convolution of layout {numbers}')
    if groups != 1:
      raise NotImplementedError('a plain convolution with feature groups')
    raw = self.tf.raw_ops
    kernel = [int(w.shape[0]), int(w.shape[1])]
    if any(d != 1 for d in lhs_dil):
      # y = conv(dilate(x, s), w, pad (lo, hi)) is the input gradient of a
      # stride-s convolution of y's shape by the flipped, transposed
      # kernel with padding (k - 1 - lo, k - 1 - hi).
      if any(s != 1 for s in strides) or any(d != 1 for d in rhs_dil):
        raise NotImplementedError('lhs dilation with strides or rhs dilation')
      flipped = raw.Transpose(x=raw.ReverseV2(tensor=w, axis=self._ints([0, 1])),
                              perm=self._ints([0, 1, 3, 2]))
      explicit = [0, 0]
      for k, (lo, hi) in zip(kernel, padding):
        explicit += [k - 1 - lo, k - 1 - hi]
      explicit += [0, 0]
      return raw.Conv2DBackpropInput(
          input_sizes=self._ints(out_aval.shape), filter=flipped,
          out_backprop=x, strides=[1, *lhs_dil, 1], padding='EXPLICIT',
          explicit_paddings=explicit)
    pad_name, explicit = self._padding_name(
        [int(d) for d in x.shape[1:3]], kernel, strides, rhs_dil, padding)
    return raw.Conv2D(input=x, filter=w, strides=[1, *strides, 1],
                      padding=pad_name, explicit_paddings=explicit,
                      dilations=[1, *rhs_dil, 1])

  @staticmethod
  def _padding_name(sizes, kernel, strides, dilations, padding):
    """'VALID', 'SAME' (TF's split: the odd element at the end) or
    'EXPLICIT' with its NHWC paddings."""
    if all(p == (0, 0) for p in padding):
      return 'VALID', []
    same = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
      total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
      same.append((total // 2, total - total // 2))
    if same == list(padding):
      return 'SAME', []
    return 'EXPLICIT', [0, 0, *[p for pair in padding for p in pair], 0, 0]

  def _max_window(self, x, params):
    from tensorflow.compiler.tf2xla.python import xla as tfxla

    tf = self.tf
    window = tuple(params['window_dimensions'])
    strides = tuple(params['window_strides'])
    padding = [tuple(p) for p in params['padding']]
    base = tuple(params['base_dilation'])
    dil = tuple(params['window_dilation'])
    if self.mode == 'xla':
      if self._max_reducer is None:
        spec = tf.TensorSpec((), x.dtype)
        self._max_reducer = tf.function(
            lambda a, b: tf.raw_ops.Maximum(x=a, y=b), autograph=False,
            jit_compile=True).get_concrete_function(spec, spec)
      return tfxla.reduce_window(
          x, tf.constant(-np.inf, x.dtype), self._max_reducer,
          window_dimensions=window, window_strides=strides,
          base_dilations=base, window_dilations=dil, padding=padding)
    if (len(window) != 4 or window[0] != 1 or window[3] != 1
        or strides[0] != 1 or strides[3] != 1 or any(d != 1 for d in base)
        or any(d != 1 for d in dil)):
      raise NotImplementedError(f'a plain max pool of window {window}')
    pad_name, _ = self._padding_name(
        [int(d) for d in x.shape[1:3]], window[1:3], strides[1:3], (1, 1),
        padding[1:3])
    if pad_name == 'EXPLICIT' or padding[0] != (0, 0) or padding[3] != (0, 0):
      raise NotImplementedError(f'a plain max pool with padding {padding}')
    return tf.raw_ops.MaxPool(input=x, ksize=list(window),
                              strides=list(strides), padding=pad_name)


# --- the SavedModels ---------------------------------------------------------


def write_policy(fn, params, example, save_dir: str, mode: str,
                 input_name: str = 'input'):
  """Saves `fn(params, x)` (x an array, or a dict of arrays, as `example`)
  as a SavedModel of TF ops in `mode`, params as variables. Returns the
  TF ops of its graphs, sorted."""
  import jax
  import tensorflow as tf

  leaves, _ = jax.tree_util.tree_flatten(params)
  closed = jax.make_jaxpr(fn)(params, example)
  module = tf.Module()
  module.weights = [tf.Variable(np.asarray(leaf), name=f'w{i}')
                    for i, leaf in enumerate(leaves)]
  if isinstance(example, dict):
    signature = [{k: tf.TensorSpec(np.shape(v), tf.float32, name=k)
                  for k, v in example.items()}]
  else:
    signature = [tf.TensorSpec(np.shape(example), tf.float32,
                               name=input_name)]
  translate = Translator(mode)

  def call(x):
    args = [tf.convert_to_tensor(v) for v in module.weights]
    outs = translate(closed, args + tf.nest.flatten(x))
    return outs[0] if len(outs) == 1 else tuple(outs)

  module.__call__ = tf.function(call, input_signature=signature,
                                autograph=False, jit_compile=mode == 'xla')
  shutil.rmtree(save_dir, ignore_errors=True)
  tf.saved_model.save(module, save_dir)
  fingerprint = os.path.join(save_dir, 'fingerprint.pb')
  if os.path.exists(fingerprint):
    os.remove(fingerprint)
  return graph_ops(save_dir)


def graph_ops(save_dir: str):
  from tensorflow.core.protobuf import saved_model_pb2

  saved = saved_model_pb2.SavedModel()
  with open(os.path.join(save_dir, 'saved_model.pb'), 'rb') as f:
    saved.ParseFromString(f.read())
  graph = saved.meta_graphs[0].graph_def
  ops = {n.op for n in graph.node}
  for function in graph.library.function:
    ops.update(n.op for n in function.node_def)
  return sorted(ops)


def _models():
  """(name, fn(params, x), params, example input, input name, seed)."""
  import jax
  import jax.numpy as jnp

  from putting_dune_tpu.agents import eval_agent
  from putting_dune_tpu.atom_detection import model as det_model
  from putting_dune_tpu.image_alignment import model as align_model
  from putting_dune_tpu.rate_learning import config as rl_config
  from putting_dune_tpu.rate_learning import losses
  from putting_dune_tpu.rate_learning import model as model_lib
  from putting_dune_tpu.rate_learning import predictor as predictor_lib

  models = []
  agent = eval_agent.EvalAgent.load(os.path.join(
      REPO, 'putting_dune_tpu', 'experiments', 'model_weights',
      '230422_ppo_v3_2s'))
  mlp = agent._module  # pylint: disable=protected-access
  obs_dim = agent.params['Dense_0']['kernel'].shape[0]
  models.append(('ppo_v3_2s', lambda p, x: mlp.apply({'params': p}, x),
                 agent.params, np.zeros((obs_dim,), np.float32), 'input', 0))

  policy = eval_agent._ActorCriticPolicy((16, 16), (4, 6, 8), 2)  # pylint: disable=protected-access
  dummy = {'image': jnp.zeros((1, 128, 128, 1)),
           'goal_delta_angstroms': jnp.zeros((1, 2))}
  ac_params = policy._module.init(jax.random.PRNGKey(6), dummy)['params']  # pylint: disable=protected-access
  models.append((
      'actor_critic',
      lambda p, obs: policy.apply(
          {'params': p}, jax.tree_util.tree_map(lambda v: v[None], obs))[0],
      ac_params, {'image': np.zeros((128, 128, 1), np.float32),
                  'goal_delta_angstroms': np.zeros((2,), np.float32)},
      'obs', 5))

  det = det_model.UNet(features=(4, 8))
  det_params = det.init(jax.random.PRNGKey(2),
                        jnp.zeros((1, 32, 32, 1)))['params']
  models.append(('atom_detector', lambda p, x: det.apply({'params': p}, x),
                 det_params, np.zeros((1, 32, 32, 1), np.float32), 'image',
                 2))

  align = align_model.GlobalLocalUNet(local_output_size=9,
                                      global_output_size=6, features=(4, 8))
  align_params = align.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, 32, 32, 3)))['params']
  models.append(('image_aligner',
                 lambda p, x: tuple(align.apply({'params': p}, x)),
                 align_params, np.zeros((1, 32, 32, 3), np.float32), 'image',
                 3))

  config = rl_config.RateLearningConfig(num_models=2,
                                        hidden_dimensions=(16, 16))
  predictor = predictor_lib.LearnedRatePredictor(
      init_key=jax.random.PRNGKey(30), config=config)

  module = model_lib.RateMLP(
      hidden_dimensions=config.hidden_dimensions, num_states=3,
      batchnorm=config.batchnorm, dropout_rate=config.dropout_rate)

  def rates(p, x):
    """`apply_model` without its key (the eval forward draws nothing)."""
    out = jax.vmap(lambda params, state: module.apply(
        {'params': params, 'batch_stats': state}, x, is_training=False))(
            p['params'], p['state'])
    return losses.predicted_rates_to_per_neighbor(out).mean(0)

  x = _draw(np.zeros((1, 4), np.float32), 1)
  np.testing.assert_allclose(
      np.asarray(rates({'params': predictor.params,
                        'state': predictor.state}, x)),
      np.asarray(predictor.apply_model(x)), rtol=TOLERANCE, atol=TOLERANCE)
  models.append(('rate_predictor', rates,
                 {'params': predictor.params, 'state': predictor.state},
                 np.zeros((1, 4), np.float32), 'beam_position', 1))
  return models


def _draw(example, seed):
  rng = np.random.default_rng(seed)
  if isinstance(example, dict):
    return {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in sorted(example.items())}
  return rng.standard_normal(np.shape(example)).astype(np.float32)


def make(out_root: str) -> dict:
  import jax
  import tensorflow as tf

  root = os.path.join(out_root, 'torch_tf_graphs')
  os.makedirs(root, exist_ok=True)
  index = {'jax': jax.__version__, 'tensorflow': tf.__version__,
           'tolerance': TOLERANCE, 'fixtures': {}}
  for name, fn, params, example, input_name, seed in _models():
    x = _draw(example, seed)
    want = jax.jit(fn)(params, x)
    want = want if isinstance(want, tuple) else (want,)
    for mode in MODES:
      out_dir = os.path.join(root, f'{name}_{mode}')
      os.makedirs(out_dir, exist_ok=True)
      save_dir = os.path.join(out_dir, 'saved_model')
      ops = write_policy(fn, params, example, save_dir, mode, input_name)
      got = tf.saved_model.load(save_dir)(x)
      got = got if isinstance(got, tuple) else (got,)
      for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=TOLERANCE, atol=TOLERANCE,
                                   err_msg=f'{name}_{mode} output {i}')
        np.save(os.path.join(out_dir, f'output_{i}.npy'), np.asarray(g))
      if isinstance(x, dict):
        for k, v in x.items():
          np.save(os.path.join(out_dir, f'input_{k}.npy'), v)
      else:
        np.save(os.path.join(out_dir, 'input.npy'), x)
      index['fixtures'][f'{name}_{mode}'] = {
          'inputs': sorted(x) if isinstance(x, dict) else None,
          'outputs': len(want), 'ops': ops}
  with open(os.path.join(root, 'index.json'), 'w') as f:
    json.dump(index, f, indent=1, sort_keys=True)
  return index


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out_dir', default=os.path.join(REPO, 'tests',
                                                        'data'))
  args = parser.parse_args()
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  index = make(args.out_dir)
  print(json.dumps({k: v for k, v in index.items() if k != 'fixtures'},
                   sort_keys=True))
  for name, entry in index['fixtures'].items():
    print(name, ' '.join(entry['ops']))


if __name__ == '__main__':
  main()
