"""The learners' files: sklearn's `.joblib` files, read and written
without sklearn or joblib.

Reading a joblib file: a restricted unpickler. Every global the pickle
names is looked up in a whitelist of sklearn, joblib and numpy paths; a
whitelisted sklearn or joblib class becomes an inert record of its
constructor arguments and state (nothing of it is imported or called),
numpy's array, dtype and scalar constructors are numpy's own, and any
other name raises `pickle.UnpicklingError` before anything is called.
joblib's `NumpyArrayWrapper` payloads (the raw array bytes that follow a
wrapper in the file, after its alignment padding) are read as joblib reads
them. The records are then turned into the port's classes: `Pipeline`,
`StandardScaler`, `KNeighborsClassifier`, `RandomForestClassifier` (each
tree's `nodes` structured array and `values`), `MLPClassifier` (`coefs_`,
`intercepts_`), `SVC` (support vectors, libsvm's dual coefficients and
intercepts, `probA_` / `probB_`), `GaussianProcessClassifier` (each
binary classifier's `X_train_`, `W_sr_`, `pi_`, `L_` and its kernel's
scales) and the soft `VotingClassifier` the rate-learner CLI writes. Only
uncompressed files (joblib's default) are read.

Writing (`dump`): the port's fitted estimators as the uncompressed pickle
`joblib.dump` writes of the sklearn 1.9 objects the JAX package's CLI
fits, so that `joblib.load` gives working sklearn estimators. The stream
is built with the stdlib's pure-Python pickler: each sklearn or joblib
class is named by its module path (`STACK_GLOBAL`), never imported, and
carries the state sklearn 1.9 gives it after `fit` (its `__dict__` with
`_sklearn_version`, so loading warns of no version change); each numpy
array follows its `NumpyArrayWrapper` as raw bytes after joblib's
alignment padding. The KNN classifier carries a KD tree built as
sklearn's `KDTree` builds it (leaf size 30, the widest dimension split at
the median), so sklearn queries it as it queries its own: distances summed
feature by feature, as the port's. Arrays are written in the dtypes the
port computes in (float64 where sklearn kept a float32 input), so that
sklearn's `predict_proba` on the file reproduces the port's.
"""

from __future__ import annotations

import math
import pickle
from typing import Dict

import numpy as np
import torch

from putting_dune_torch.classifiers import _base
from putting_dune_torch.classifiers import ensemble
from putting_dune_torch.classifiers import gaussian_process
from putting_dune_torch.classifiers import neighbors
from putting_dune_torch.classifiers import neural_network
from putting_dune_torch.classifiers import preprocessing
from putting_dune_torch.classifiers import svm
from putting_dune_torch.classifiers import tree

SUFFIX = '.joblib'
SKLEARN_VERSION = '1.9.0'

# Whitelisted classes and functions that become inert records.
RECORDED = frozenset((
    'joblib.numpy_pickle.NumpyArrayWrapper',
    'sklearn.pipeline.Pipeline',
    'sklearn.preprocessing._data.StandardScaler',
    'sklearn.preprocessing._label.LabelBinarizer',
    'sklearn.preprocessing._label.LabelEncoder',
    'sklearn.neighbors._classification.KNeighborsClassifier',
    'sklearn.neighbors._kd_tree.KDTree',
    'sklearn.neighbors._kd_tree.newObj',
    'sklearn.neighbors._ball_tree.BallTree',
    'sklearn.neighbors._ball_tree.newObj',
    'sklearn.metrics._dist_metrics.EuclideanDistance64',
    'sklearn.metrics._dist_metrics.newObj',
    'sklearn.ensemble._forest.RandomForestClassifier',
    'sklearn.tree._classes.DecisionTreeClassifier',
    'sklearn.tree._tree.Tree',
    'sklearn.neural_network._multilayer_perceptron.MLPClassifier',
    'sklearn.neural_network._stochastic_optimizers.AdamOptimizer',
    'sklearn.svm._classes.SVC',
    'sklearn.gaussian_process._gpc.GaussianProcessClassifier',
    'sklearn.gaussian_process._gpc._BinaryGaussianProcessClassifierLaplace',
    'sklearn.gaussian_process.kernels.ConstantKernel',
    'sklearn.gaussian_process.kernels.Product',
    'sklearn.gaussian_process.kernels.RBF',
    'sklearn.multiclass.OneVsRestClassifier',
    'sklearn.ensemble._voting.VotingClassifier',
    'numpy.random.mtrand.RandomState',
    'numpy.random._pickle.__randomstate_ctor',
    'numpy.random._pickle.__bit_generator_ctor',
    'numpy.random._mt19937.MT19937',
    'numpy.random.bit_generator.SeedSequence',
    'numpy.random.bit_generator.__pyx_unpickle_SeedSequence',
))

# numpy's own constructors of arrays, dtypes and scalars.
_NUMPY = {}
for _module in ('numpy._core.multiarray', 'numpy.core.multiarray'):
  _NUMPY[f'{_module}._reconstruct'] = np.ndarray.__reduce__(
      np.zeros(1))[0]
  _NUMPY[f'{_module}.scalar'] = np.float64(0).__reduce__()[0]
_NUMPY['numpy.ndarray'] = np.ndarray
_NUMPY['numpy.dtype'] = np.dtype
del _module


class Record:
  """An inert stand-in for a whitelisted class or function: the path it
  names, the arguments it was given and the state it was built with."""

  path = ''

  def __new__(cls, *args, **kwargs):
    obj = object.__new__(cls)
    obj.args, obj.state = args, None
    return obj

  def __init__(self, *args, **kwargs):
    pass

  def __setstate__(self, state):
    self.state = state

  def __getitem__(self, key):
    return self.state[key]

  def get(self, key, default=None):
    return (self.state or {}).get(key, default)

  def __repr__(self) -> str:
    return f'Record({self.path})'


_RECORD_TYPES: Dict[str, type] = {}


def _record_type(path: str) -> type:
  if path not in _RECORD_TYPES:
    _RECORD_TYPES[path] = type('Record', (Record,), {'path': path})
  return _RECORD_TYPES[path]


class RestrictedUnpickler(pickle._Unpickler):  # the pure-Python one
  """pickle's unpickler with `find_class` held to the whitelist and
  joblib's array payloads read after each `NumpyArrayWrapper`."""

  def __init__(self, file):
    super().__init__(file)
    self.file_handle = file

  def find_class(self, module: str, name: str):
    path = f'{module}.{name}'
    if path in _NUMPY:
      return _NUMPY[path]
    if path in RECORDED:
      return _record_type(path)
    raise pickle.UnpicklingError(
        f'{path} is not on the whitelist of classes a learner file may '
        'name; it was not imported or called')

  def _load_build(self):
    pickle._Unpickler.load_build(self)
    top = self.stack[-1]
    if isinstance(top, Record) and (
        top.path == 'joblib.numpy_pickle.NumpyArrayWrapper'):
      self.stack[-1] = self._read_array(top.state)

  dispatch = dict(pickle._Unpickler.dispatch)
  dispatch[pickle.BUILD[0]] = _load_build

  def _read_array(self, meta) -> np.ndarray:
    """joblib's `NumpyArrayWrapper.read_array` for uncompressed files."""
    dtype, shape = meta['dtype'], tuple(meta['shape'])
    if dtype.hasobject:
      return RestrictedUnpickler(self.file_handle).load()
    if meta.get('numpy_array_alignment_bytes') is not None:
      padding = int.from_bytes(self.file_handle.read(1), 'little')
      self.file_handle.read(padding)
    count = math.prod(shape)
    data = self.file_handle.read(count * dtype.itemsize)
    if len(data) != count * dtype.itemsize:
      raise pickle.UnpicklingError('the file ends inside an array')
    array = np.frombuffer(data, dtype=dtype, count=count).copy()
    if meta['order'] == 'F':
      array = array.reshape(shape[::-1]).transpose()
    else:
      array = array.reshape(shape)
    return array.astype(array.dtype.newbyteorder('='), copy=False)


def read_records(path: str):
  """The object tree of a joblib file, whitelisted classes as Records."""
  with open(path, 'rb') as f:
    if f.read(1) != b'\x80':
      raise ValueError(f'{path}: not an uncompressed joblib pickle (the '
                       'port reads joblib files written without compression)')
    f.seek(0)
    return RestrictedUnpickler(f).load()


# --- records to the port's classes -------------------------------------------


def _t(array, device, dtype=_base.F64) -> torch.Tensor:
  return torch.as_tensor(np.asarray(array), dtype=dtype, device=device)


def _new(cls, device):
  est = cls.__new__(cls)
  est.device = torch.device(device)
  return est


def _scaler(rec, device):
  if not (rec['with_mean'] and rec['with_std']):
    raise ValueError('only a centring and scaling StandardScaler is ported')
  est = _new(preprocessing.StandardScaler, device)
  est.n_samples_seen_ = float(rec['n_samples_seen_'])
  est.n_features_in_ = int(rec['n_features_in_'])
  for name in ('mean_', 'var_', 'scale_'):
    setattr(est, name, _t(rec[name], device))
  return est


def _knn(rec, device):
  if rec['weights'] != 'uniform':
    raise ValueError('only uniform KNN weights are ported')
  est = _new(neighbors.KNeighborsClassifier, device)
  est.n_neighbors = int(rec['n_neighbors'])
  est.n_features_in_ = int(rec['n_features_in_'])
  est.classes_ = np.asarray(rec['classes_'])
  est._fit_X = _t(rec['_fit_X'], device)
  est._y = _t(rec['_y'], device, torch.int64)
  return est


def _tree(rec, device, classes):
  state = rec['tree_'].state
  nodes = state['nodes']
  est = _new(tree.DecisionTreeClassifier, device)
  est.max_depth, est.max_features = rec['max_depth'], rec['max_features']
  est.random_state = rec['random_state']
  est.classes_ = classes
  est.children_left = _t(nodes['left_child'], device, torch.int64)
  est.children_right = _t(nodes['right_child'], device, torch.int64)
  est.feature = _t(nodes['feature'], device, torch.int64)
  est.threshold = _t(nodes['threshold'], device)
  est.impurity = _t(nodes['impurity'], device)
  est.n_node_samples = _t(nodes['n_node_samples'], device, torch.int64)
  est.weighted_n_node_samples = _t(nodes['weighted_n_node_samples'], device)
  est.value = _t(state['values'][:, 0, :len(classes)], device)
  return est


def _forest(rec, device):
  est = _new(ensemble.RandomForestClassifier, device)
  est.n_estimators, est.max_depth = rec['n_estimators'], rec['max_depth']
  est.random_state = rec['random_state']
  est.classes_ = np.asarray(rec['classes_'])
  est.n_features_in_ = int(rec['n_features_in_'])
  est.estimators_ = [_tree(t, device, est.classes_)
                     for t in rec['estimators_']]
  return est


def _mlp(rec, device):
  est = _new(neural_network.MLPClassifier, device)
  for name in ('alpha', 'max_iter', 'shuffle', 'tol'):
    setattr(est, name, rec[name])
  est.random_state = rec['random_state']
  if rec['activation'] != 'relu':
    raise ValueError('only ReLU MLPs are ported')
  est.classes_ = np.asarray(rec['classes_'])
  est.n_features_in_ = int(rec['n_features_in_'])
  est.out_activation_ = rec['out_activation_']
  est.coefs_ = [_t(c, device) for c in rec['coefs_']]
  est.intercepts_ = [_t(b, device) for b in rec['intercepts_']]
  est.n_iter_ = int(rec['n_iter_'])
  est.loss_ = float(rec['loss_'])
  est.best_loss_ = float(rec['best_loss_'])
  est.loss_curve_ = [float(v) for v in rec['loss_curve_']]
  est.t_ = int(rec['t_'])
  est._no_improvement_count = int(rec['_no_improvement_count'])
  est._best_coefs = [_t(c, device) for c in rec['_best_coefs']]
  est._best_intercepts = [_t(b, device) for b in rec['_best_intercepts']]
  adam = rec['_optimizer']
  est._adam = {'t': int(adam['t']),
               'learning_rate': float(adam['learning_rate']),
               'ms': [_t(m, device) for m in adam['ms']],
               'vs': [_t(v, device) for v in adam['vs']]}
  est._random_state = _random_state(rec['_random_state'])
  return est


def _random_state(rec) -> np.random.RandomState:
  """A pickled `RandomState` (a Record of numpy's constructor) rebuilt
  from its MT19937 state."""
  state = rec.state
  rng = np.random.RandomState()
  rng.set_state((state['bit_generator'], state['state']['key'],
                 state['state']['pos'], state['has_gauss'], state['gauss']))
  return rng


def _svc(rec, device):
  if rec['kernel'] != 'rbf':
    raise ValueError('only RBF SVCs are ported')
  est = _new(svm.SVC, device)
  est.C, est.gamma, est.tol = rec['C'], float(rec['_gamma']), rec['tol']
  est.probability, est.random_state = rec['probability'], rec['random_state']
  est.classes_ = np.asarray(rec['classes_'])
  est.n_features_in_ = int(rec['n_features_in_'])
  est.support_ = np.asarray(rec['support_'])
  est.shape_fit_ = tuple(rec['shape_fit_'])
  est.pair_iterations_ = np.asarray(rec['_num_iter'])
  est.support_vectors_ = _t(rec['support_vectors_'], device)
  est.n_support_ = _t(rec['_n_support'], device, torch.int64)
  est.dual_coef = _t(rec['_dual_coef_'], device)
  est.rho = -_t(rec['_intercept_'], device)  # sklearn keeps -rho
  prob_a, prob_b = rec.get('_probA'), rec.get('_probB')
  has_prob = prob_a is not None and np.asarray(prob_a).size
  est.prob_a = _t(prob_a, device) if has_prob else None
  est.prob_b = _t(prob_b, device) if has_prob else None
  return est


def _binary_laplace(rec, device):
  kern = rec['kernel_']
  const, rbf = kern['k1'], kern['k2']
  if (const.path != 'sklearn.gaussian_process.kernels.ConstantKernel'
      or rbf.path != 'sklearn.gaussian_process.kernels.RBF'
      or np.ndim(rbf['length_scale']) != 0):
    raise ValueError('only the kernel 1.0 * RBF(1.0) is ported')
  est = _new(gaussian_process.BinaryLaplace, device)
  est.optimize = rec['optimizer'] is not None
  est.classes_ = np.asarray(rec['classes_'])
  est.scales = (float(const['constant_value']), float(rbf['length_scale']))
  est.X_train_ = _t(rec['X_train_'], device)
  est.y_train_ = _t(rec['y_train_'], device)
  est.pi_ = _t(rec['pi_'], device)
  est.W_sr_ = _t(rec['W_sr_'], device)
  est.L_ = _t(rec['L_'], device)
  est.f_cached = _t(rec['f_cached'], device)
  est.log_marginal_likelihood_value_ = float(
      rec['log_marginal_likelihood_value_'])
  return est


def _gpc(rec, device):
  est = _new(gaussian_process.GaussianProcessClassifier, device)
  est.optimizer = rec['optimizer']
  est.classes_ = np.asarray(rec['classes_'])
  est.n_features_in_ = int(rec['n_features_in_'])
  base = rec['base_estimator_']
  if base.path == 'sklearn.multiclass.OneVsRestClassifier':
    est.estimators_ = [_binary_laplace(e, device) for e in base['estimators_']]
  else:
    est.estimators_ = [_binary_laplace(base, device)]
  return est


def _pipeline(rec, device):
  return preprocessing.Pipeline(
      [(name, convert(step, device)) for name, step in rec['steps']])


def _voting(rec, device):
  if rec['voting'] != 'soft':
    raise ValueError('only soft voting is ported')
  names = [name for name, _ in rec['estimators']]
  return ensemble.VotingClassifier(
      [(name, convert(est, device))
       for name, est in zip(names, rec['estimators_'])])


_CONVERTERS = {
    'sklearn.pipeline.Pipeline': _pipeline,
    'sklearn.preprocessing._data.StandardScaler': _scaler,
    'sklearn.neighbors._classification.KNeighborsClassifier': _knn,
    'sklearn.ensemble._forest.RandomForestClassifier': _forest,
    'sklearn.neural_network._multilayer_perceptron.MLPClassifier': _mlp,
    'sklearn.svm._classes.SVC': _svc,
    'sklearn.gaussian_process._gpc.GaussianProcessClassifier': _gpc,
    'sklearn.ensemble._voting.VotingClassifier': _voting,
}


def convert(rec, device):
  """A Record tree as the port's estimator."""
  if not isinstance(rec, Record) or rec.path not in _CONVERTERS:
    raise ValueError(f'{rec!r} is not an estimator the port reads')
  return _CONVERTERS[rec.path](rec, device)


def load(path: str, device=None):
  """Reads a `.joblib` file of one of the CLI's learners (the JAX
  package's or `dump`'s) as the port's estimator on `device`."""
  from putting_dune_torch import device as device_lib

  return convert(read_records(path), device_lib.resolve_device(device))


# --- writing -----------------------------------------------------------------


class _Global:
  """A class or function named by its module path, not imported."""

  def __init__(self, path: str):
    self.module, _, self.name = path.rpartition('.')


class _Object:
  """An object as pickle rebuilds it, then sets its state (BUILD): the
  class at `path` called with no arguments (NEWOBJ), or, given `args`,
  the callable at `path` called with them (REDUCE)."""

  def __init__(self, path: str, state, args: tuple = None):
    self.callable = _Global(path)
    self.state, self.args = state, args


def _sk(path: str, **state) -> _Object:
  """An sklearn estimator: its `__dict__` and the version `__getstate__`
  adds."""
  return _Object(path, dict(state, _sklearn_version=SKLEARN_VERSION))


class _JoblibPickler(pickle._Pickler):  # the pure-Python one, as joblib's
  """pickle's writer with `_Global` / `_Object` saved by name and numpy
  arrays as joblib's `NumpyArrayWrapper` followed by their bytes."""

  dispatch = dict(pickle._Pickler.dispatch)

  def __init__(self, file):
    super().__init__(file, protocol=4)  # joblib's, pickle.DEFAULT_PROTOCOL
    self.file_handle = file

  def _save_global(self, obj: _Global):
    self.save(obj.module)
    self.save(obj.name)
    self.write(pickle.STACK_GLOBAL)
    self.memoize(obj)

  def _save_object(self, obj: _Object):
    self.save(obj.callable)
    self.save(() if obj.args is None else obj.args)
    self.write(pickle.NEWOBJ if obj.args is None else pickle.REDUCE)
    self.memoize(obj)
    self.save(obj.state)
    self.write(pickle.BUILD)

  dispatch[_Global] = _save_global
  dispatch[_Object] = _save_object

  def save(self, obj, save_persistent_id=True):
    if type(obj) is not np.ndarray or obj.dtype.hasobject:
      return super().save(obj, save_persistent_id)
    # joblib's NumpyPickler.save: the wrapper, the frame flushed, then one
    # byte of padding length, the padding (to 16 bytes) and the C-order
    # bytes.
    obj = np.ascontiguousarray(obj)
    super().save(_Object('joblib.numpy_pickle.NumpyArrayWrapper', {
        'subclass': np.ndarray, 'shape': obj.shape, 'order': 'C',
        'dtype': obj.dtype, 'allow_mmap': True,
        'numpy_array_alignment_bytes': 16}))
    self.framer.commit_frame(force=True)
    padding = 16 - (self.file_handle.tell() + 1) % 16
    self.file_handle.write(bytes([padding]) + b'\xff' * padding)
    self.file_handle.write(obj.tobytes())


def _np(x, dtype=np.float64) -> np.ndarray:
  return np.asarray(_base.host(x), dtype=dtype)


def _label_binarizer(classes, sparse_output: bool) -> _Object:
  return _sk('sklearn.preprocessing._label.LabelBinarizer', neg_label=0,
             pos_label=1, sparse_output=sparse_output,
             y_type_='multiclass' if len(classes) > 2 else 'binary',
             sparse_input_=False, classes_=np.asarray(classes))


def _dump_scaler(est) -> _Object:
  return _sk('sklearn.preprocessing._data.StandardScaler', with_mean=True,
             with_std=True, copy=True,
             n_features_in_=int(est.n_features_in_),
             n_samples_seen_=np.float64(est.n_samples_seen_),
             mean_=_np(est.mean_), var_=_np(est.var_),
             scale_=_np(est.scale_))


_NODE_DATA = np.dtype([('idx_start', '<i8'), ('idx_end', '<i8'),
                       ('is_leaf', '<i8'), ('radius', '<f8')])
_LEAF_SIZE = 30  # KNeighborsClassifier's default


def kd_tree_state(data: np.ndarray) -> tuple:
  """sklearn's `KDTree(data, leaf_size=30)` state (`BinaryTree.__getstate__`
  less the metric): node i of a complete binary tree holds the points
  idx[start:end], its children split them at the middle position along
  the widest dimension (a partition, as sklearn's introselect), its
  bounds are their min and max, and its radius half the bounds' diagonal."""
  n, d = data.shape
  n_levels = int(np.log2(max(1.0, (n - 1) / _LEAF_SIZE)) + 1)
  n_nodes = 2**n_levels - 1
  idx = np.arange(n, dtype=np.intp)
  nodes = np.zeros(n_nodes, _NODE_DATA)
  bounds = np.zeros((2, n_nodes, d))
  stack = [(0, 0, n)]
  while stack:
    i, start, end = stack.pop()
    points = data[idx[start:end]]
    lo, hi = points.min(axis=0), points.max(axis=0)
    bounds[0, i], bounds[1, i] = lo, hi
    leaf = 2 * i + 1 >= n_nodes or end - start < 2
    nodes[i] = (start, end, leaf, np.sqrt(np.sum((0.5 * (hi - lo))**2)))
    if not leaf:
      mid = (end - start) // 2
      order = np.argpartition(points[:, np.argmax(hi - lo)], mid)
      idx[start:end] = idx[start:end][order]
      stack += [(2 * i + 2, start + mid, end), (2 * i + 1, start, start + mid)]
  return (data, idx, nodes, bounds, _LEAF_SIZE, n_levels, n_nodes, 0, 0, 0,
          0)


def _dump_knn(est) -> _Object:
  fit_x = _np(est._fit_X)
  # Both pickle as newObj(cls) and a state tuple.
  metric = _Object(
      'sklearn.metrics._dist_metrics.newObj',
      (2.0, np.zeros(1), np.zeros((1, 1))),
      (_Global('sklearn.metrics._dist_metrics.EuclideanDistance64'),))
  kd_tree = _Object('sklearn.neighbors._kd_tree.newObj',
                    kd_tree_state(fit_x) + (metric, None),
                    (_Global('sklearn.neighbors._kd_tree.KDTree'),))
  return _sk('sklearn.neighbors._classification.KNeighborsClassifier',
             n_neighbors=int(est.n_neighbors), radius=None, algorithm='auto',
             leaf_size=_LEAF_SIZE, metric='minkowski', metric_params=None,
             p=2, n_jobs=None, weights='uniform',
             n_features_in_=int(est.n_features_in_),
             outputs_2d_=False, classes_=np.asarray(est.classes_),
             _y=_np(est._y, np.int64), effective_metric_params_={},
             effective_metric_='euclidean', _fit_method='kd_tree',
             _fit_X=fit_x, n_samples_fit_=fit_x.shape[0], _tree=kd_tree)


_NODE_DTYPE = np.dtype({
    'names': ['left_child', 'right_child', 'feature', 'threshold',
              'impurity', 'n_node_samples', 'weighted_n_node_samples',
              'missing_go_to_left'],
    'formats': ['<i8', '<i8', '<i8', '<f8', '<f8', '<i8', '<f8', 'u1'],
    'offsets': [0, 8, 16, 24, 32, 40, 48, 56], 'itemsize': 64})
_TREE_PARAMS = dict(
    criterion='gini', splitter='best', max_depth=None, min_samples_split=2,
    min_samples_leaf=1, min_weight_fraction_leaf=0.0, max_features=None,
    max_leaf_nodes=None, random_state=None, min_impurity_decrease=0.0,
    class_weight=None, ccp_alpha=0.0, monotonic_cst=None)
_ESTIMATOR_PARAMS = ('criterion', 'max_depth', 'min_samples_split',
                     'min_samples_leaf', 'min_weight_fraction_leaf',
                     'max_features', 'max_leaf_nodes',
                     'min_impurity_decrease', 'random_state', 'ccp_alpha',
                     'monotonic_cst')


def _dump_tree(est, n_features: int, n_classes: int) -> _Object:
  left, right = _np(est.children_left, np.int64), _np(est.children_right,
                                                       np.int64)
  count = _np(est.n_node_samples, np.int64)
  nodes = np.zeros(len(left), _NODE_DTYPE)
  nodes['left_child'], nodes['right_child'] = left, right
  nodes['feature'] = _np(est.feature, np.int64)
  nodes['threshold'] = _np(est.threshold)
  nodes['impurity'] = _np(est.impurity)
  nodes['n_node_samples'] = count
  nodes['weighted_n_node_samples'] = _np(est.weighted_n_node_samples)
  # With no missing values in training, sklearn sends them to the child
  # that saw more samples.
  inner = left >= 0
  nodes['missing_go_to_left'][inner] = count[left[inner]] > count[
      right[inner]]
  depth = np.zeros(len(left), np.int64)
  for i in range(len(left)):  # children come after their parent
    if inner[i]:
      depth[left[i]] = depth[right[i]] = depth[i] + 1
  # Tree(n_features, n_classes, n_outputs), then its state.
  tree_state = _Object('sklearn.tree._tree.Tree', {
      'max_depth': int(depth.max()), 'node_count': len(left), 'nodes': nodes,
      'values': _np(est.value)[:, None, :]},
                       (n_features, np.asarray([n_classes], np.intp), 1))
  params = dict(_TREE_PARAMS, max_depth=est.max_depth,
                max_features=est.max_features, random_state=est.random_state)
  return _sk('sklearn.tree._classes.DecisionTreeClassifier', **params,
             n_features_in_=n_features, n_outputs_=1,
             classes_=np.arange(n_classes, dtype=np.float64),
             n_classes_=np.int64(n_classes),
             max_features_=tree.resolve_max_features(est.max_features,
                                                     n_features),
             tree_=tree_state)


def _tree_template() -> _Object:
  return _sk('sklearn.tree._classes.DecisionTreeClassifier', **_TREE_PARAMS)


def _dump_forest(est) -> _Object:
  k, n_features = len(est.classes_), int(est.n_features_in_)
  # The bootstrap draws as many rows as were fitted: a tree's root weight.
  samples = int(round(float(est.estimators_[0].weighted_n_node_samples[0])))
  return _sk(
      'sklearn.ensemble._forest.RandomForestClassifier',
      estimator=_tree_template(),
      n_estimators=int(est.n_estimators), estimator_params=_ESTIMATOR_PARAMS,
      bootstrap=True, oob_score=False, n_jobs=None,
      random_state=est.random_state, verbose=0, warm_start=False,
      class_weight=None, max_samples=None, criterion='gini',
      max_depth=est.max_depth, min_samples_split=2, min_samples_leaf=1,
      min_weight_fraction_leaf=0.0, max_features='sqrt',
      max_leaf_nodes=None, min_impurity_decrease=0.0, monotonic_cst=None,
      ccp_alpha=0.0, n_features_in_=n_features, _n_samples=samples,
      n_outputs_=1, classes_=np.asarray(est.classes_), n_classes_=k,
      _sample_weight=None, _n_samples_bootstrap=samples,
      estimator_=_tree_template(),
      estimators_=[_dump_tree(t, n_features, k) for t in est.estimators_])


def _dump_mlp(est) -> _Object:
  k = len(est.classes_)
  coefs, intercepts = [_np(c) for c in est.coefs_], [_np(b) for b in
                                                       est.intercepts_]
  adam = est._adam
  optimizer = _Object(
      'sklearn.neural_network._stochastic_optimizers.AdamOptimizer', {
          'learning_rate_init': neural_network.LEARNING_RATE,
          'learning_rate': np.float64(adam['learning_rate']),
          'beta_1': neural_network.BETA_1, 'beta_2': neural_network.BETA_2,
          'epsilon': neural_network.ADAM_EPS, 't': int(adam['t']),
          'ms': [_np(m) for m in adam['ms']],
          'vs': [_np(v) for v in adam['vs']]})
  return _sk(
      'sklearn.neural_network._multilayer_perceptron.MLPClassifier',
      activation='relu', solver='adam', alpha=est.alpha, batch_size='auto',
      learning_rate='constant',
      learning_rate_init=neural_network.LEARNING_RATE, power_t=0.5,
      max_iter=est.max_iter, loss='log_loss',
      hidden_layer_sizes=tuple(neural_network.HIDDEN), shuffle=est.shuffle,
      random_state=est.random_state, tol=est.tol, verbose=False,
      warm_start=False, momentum=0.9, nesterovs_momentum=True,
      early_stopping=False, validation_fraction=0.1,
      beta_1=neural_network.BETA_1, beta_2=neural_network.BETA_2,
      epsilon=neural_network.ADAM_EPS,
      n_iter_no_change=neural_network.N_ITER_NO_CHANGE, max_fun=15000,
      n_features_in_=int(est.n_features_in_),
      _label_binarizer=_label_binarizer(est.classes_, False),
      classes_=np.asarray(est.classes_), n_outputs_=k if k > 2 else 1,
      _random_state=est._random_state, n_iter_=int(est.n_iter_),
      t_=int(est.t_), n_layers_=len(coefs) + 1,
      out_activation_=est.out_activation_, coefs_=coefs,
      intercepts_=intercepts,
      _best_coefs=[_np(c) for c in est._best_coefs],
      _best_intercepts=[_np(b) for b in est._best_intercepts],
      loss_curve_=[np.float64(v) for v in est.loss_curve_],
      _no_improvement_count=int(est._no_improvement_count),
      best_loss_=np.float64(est.best_loss_), validation_scores_=None,
      best_validation_score_=None, _optimizer=optimizer,
      loss_=np.float64(est.loss_))


def _dump_svc(est) -> _Object:
  k = len(est.classes_)
  dual = _np(est.dual_coef)
  intercept = -_np(est.rho)  # libsvm's fit gives -rho
  iterations = np.asarray(est.pair_iterations_, np.int32)
  public_intercept, public_dual = intercept.copy(), dual
  if k == 2:  # sklearn's sign flip for two classes
    public_intercept, public_dual = -intercept, -dual
  has_prob = est.prob_a is not None
  return _sk(
      'sklearn.svm._classes.SVC', decision_function_shape='ovr',
      break_ties=False, kernel='rbf', degree=3, gamma=est.gamma, coef0=0.0,
      tol=est.tol, C=est.C, nu=0.0, epsilon=0.0, shrinking=True,
      probability=bool(est.probability), cache_size=200, class_weight=None,
      verbose=False, max_iter=-1, random_state=est.random_state,
      _sparse=False, n_features_in_=int(est.n_features_in_),
      class_weight_=np.ones(k),
      classes_=np.asarray(est.classes_),
      _effective_probability=bool(est.probability), _gamma=est.gamma,
      support_=np.asarray(est.support_, np.int32),
      support_vectors_=_np(est.support_vectors_),
      _n_support=_np(est.n_support_, np.int32), dual_coef_=public_dual,
      intercept_=public_intercept,
      _probA=_np(est.prob_a) if has_prob else np.zeros(0),
      _probB=_np(est.prob_b) if has_prob else np.zeros(0), fit_status_=0,
      _num_iter=iterations, shape_fit_=tuple(int(d) for d in est.shape_fit_),
      _intercept_=intercept, _dual_coef_=dual, n_iter_=iterations.copy())


_GP_BOUNDS = (1e-05, 100000.0)


def _gp_kernel(constant: float, length_scale: float) -> _Object:
  """`constant * RBF(length_scale)` with sklearn's default bounds."""
  return _Object('sklearn.gaussian_process.kernels.Product', {
      'k1': _Object('sklearn.gaussian_process.kernels.ConstantKernel', {
          'constant_value': constant, 'constant_value_bounds': _GP_BOUNDS}),
      'k2': _Object('sklearn.gaussian_process.kernels.RBF', {
          'length_scale': length_scale,
          'length_scale_bounds': _GP_BOUNDS})})


def _gp_params(optimizer) -> dict:
  return dict(kernel=_gp_kernel(1.0, 1.0), optimizer=optimizer,
              n_restarts_optimizer=0, max_iter_predict=100, warm_start=False,
              copy_X_train=True)


def _dump_binary_laplace(est, optimizer, classes) -> _Object:
  return _sk(
      'sklearn.gaussian_process._gpc._BinaryGaussianProcessClassifierLaplace',
      **_gp_params(optimizer), random_state=None,
      kernel_=_gp_kernel(*(np.float64(s) for s in est.scales)),
      # Only the optimiser's restarts draw from it; there are none.
      rng=np.random.RandomState(0), X_train_=_np(est.X_train_),
      y_train_=_np(est.y_train_, np.int64), classes_=np.asarray(classes),
      f_cached=_np(est.f_cached),
      log_marginal_likelihood_value_=np.float64(
          est.log_marginal_likelihood_value_),
      pi_=_np(est.pi_), W_sr_=_np(est.W_sr_), L_=_np(est.L_))


def _dump_gpc(est) -> _Object:
  classes = np.asarray(est.classes_)
  if len(est.estimators_) == 1:
    # Two classes: one classifier of the labels themselves.
    base = _dump_binary_laplace(est.estimators_[0], est.optimizer, classes)
  else:
    binaries = [_dump_binary_laplace(e, est.optimizer, e.classes_)
                for e in est.estimators_]
    template = _sk('sklearn.gaussian_process._gpc.'
                   '_BinaryGaussianProcessClassifierLaplace',
                   **_gp_params(est.optimizer), random_state=None)
    base = _sk('sklearn.multiclass.OneVsRestClassifier', estimator=template,
               n_jobs=None, verbose=0,
               label_binarizer_=_label_binarizer(classes, True),
               classes_=classes, estimators_=binaries)
  return _sk(
      'sklearn.gaussian_process._gpc.GaussianProcessClassifier',
      **_gp_params(est.optimizer), random_state=None,
      multi_class='one_vs_rest', n_jobs=None,
      n_features_in_=int(est.n_features_in_),
      base_estimator_=base, classes_=classes, n_classes_=len(classes),
      log_marginal_likelihood_value_=np.float64(np.mean(
          [e.log_marginal_likelihood_value_ for e in est.estimators_])))


_DUMPERS = {
    neighbors.KNeighborsClassifier: _dump_knn,
    ensemble.RandomForestClassifier: _dump_forest,
    neural_network.MLPClassifier: _dump_mlp,
    svm.SVC: _dump_svc,
    gaussian_process.GaussianProcessClassifier: _dump_gpc,
}


def _estimator(model) -> _Object:
  if isinstance(model, preprocessing.Pipeline):
    (scaler_name, scaler), (name, clf) = model.steps
    if not isinstance(scaler, preprocessing.StandardScaler):
      raise ValueError('only a StandardScaler pipeline is written')
    return _sk('sklearn.pipeline.Pipeline', steps=[
        (scaler_name, _dump_scaler(scaler)),
        (name, _estimator(clf))], transform_input=None,
               memory=None, verbose=False)
  if isinstance(model, ensemble.VotingClassifier):
    # As the rate-learner CLI builds it: the fitted estimators set
    # directly and no label encoder.
    members = [_estimator(est) for est in model.estimators_]
    return _sk('sklearn.ensemble._voting.VotingClassifier',
               estimators=list(zip(model.names, members)), voting='soft',
               weights=None, n_jobs=None, flatten_transform=True,
               verbose=False, estimators_=members, le_=None)
  if type(model) not in _DUMPERS:
    raise ValueError(f'{type(model).__name__} is not a learner the port '
                     'writes')
  return _DUMPERS[type(model)](model)


def dump(model, path: str) -> None:
  """Writes `model` (a learner of the rate-learner CLI, fitted by the port
  or read by `load`) as `joblib.dump` writes the sklearn estimator."""
  with open(path, 'wb') as f:
    _JoblibPickler(f).dump(_estimator(model))
