"""The learners' files: the JAX package's `.joblib` files read without
sklearn or joblib, and the port's own format, written and read.

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
theta) and the soft `VotingClassifier` the rate-learner CLI writes. Only
uncompressed files (joblib's default) are read.

The port's own files (`save` / `load`): one `.npz` per model, its arrays
plus a JSON header (`__header__`, UTF-8 bytes) that describes the
estimator tree. The JAX package cannot read them.
"""

from __future__ import annotations

import json
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

SUFFIX = '.npz'
FORMAT = 'putting_dune_torch.classifiers'
VERSION = 1

REGISTRY: Dict[str, type] = {cls.__name__: cls for cls in (
    preprocessing.StandardScaler, preprocessing.Pipeline,
    neighbors.KNeighborsClassifier, tree.DecisionTreeClassifier,
    ensemble.RandomForestClassifier, ensemble.VotingClassifier,
    neural_network.MLPClassifier, svm.SVC,
    gaussian_process.GaussianProcessClassifier,
    gaussian_process.BinaryLaplace)}

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
  for name in ('mean_', 'var_', 'scale_'):
    setattr(est, name, _t(rec[name], device))
  return est


def _knn(rec, device):
  if rec['weights'] != 'uniform':
    raise ValueError('only uniform KNN weights are ported')
  est = _new(neighbors.KNeighborsClassifier, device)
  est.n_neighbors = int(rec['n_neighbors'])
  est.classes_ = np.asarray(rec['classes_'])
  est._fit_X = _t(rec['_fit_X'], device)
  est._y = _t(rec['_y'], device, torch.int64)
  return est


def _tree(rec, device, classes):
  state = rec['tree_'].state
  nodes = state['nodes']
  est = _new(tree.DecisionTreeClassifier, device)
  est.max_depth, est.max_features = rec['max_depth'], rec['max_features']
  est.random_state = None
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
  est.random_state = None
  est.classes_ = np.asarray(rec['classes_'])
  est.estimators_ = [_tree(t, device, est.classes_)
                     for t in rec['estimators_']]
  return est


def _mlp(rec, device):
  est = _new(neural_network.MLPClassifier, device)
  for name in ('alpha', 'max_iter', 'shuffle', 'tol'):
    setattr(est, name, rec[name])
  est.random_state = None
  if rec['activation'] != 'relu':
    raise ValueError('only ReLU MLPs are ported')
  est.classes_ = np.asarray(rec['classes_'])
  est.out_activation_ = rec['out_activation_']
  est.coefs_ = [_t(c, device) for c in rec['coefs_']]
  est.intercepts_ = [_t(b, device) for b in rec['intercepts_']]
  est.n_iter_ = int(rec['n_iter_'])
  est.loss_ = float(rec['loss_'])
  est.best_loss_ = float(rec['best_loss_'])
  est.loss_curve_ = [float(v) for v in rec['loss_curve_']]
  return est


def _svc(rec, device):
  if rec['kernel'] != 'rbf':
    raise ValueError('only RBF SVCs are ported')
  est = _new(svm.SVC, device)
  est.C, est.gamma, est.tol = rec['C'], float(rec['_gamma']), rec['tol']
  est.probability, est.random_state = rec['probability'], None
  est.classes_ = np.asarray(rec['classes_'])
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
  est.theta = _t([math.log(const['constant_value']),
                  math.log(rbf['length_scale'])], device)
  est.X_train_ = _t(rec['X_train_'], device)
  est.y_train_ = _t(rec['y_train_'], device)
  est.pi_ = _t(rec['pi_'], device)
  est.W_sr_ = _t(rec['W_sr_'], device)
  est.L_ = _t(rec['L_'], device)
  est.log_marginal_likelihood_value_ = float(
      rec['log_marginal_likelihood_value_'])
  return est


def _gpc(rec, device):
  est = _new(gaussian_process.GaussianProcessClassifier, device)
  est.optimizer = rec['optimizer']
  est.classes_ = np.asarray(rec['classes_'])
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


# --- the port's own format ---------------------------------------------------


def save(model, path: str) -> None:
  """Writes `model` as one `.npz`: its arrays and a JSON header."""
  arrays: Dict[str, np.ndarray] = {}
  tree_desc = model.state_tree(arrays, '')
  header = json.dumps({'format': FORMAT, 'version': VERSION,
                       'model': tree_desc})
  with open(path, 'wb') as f:
    np.savez(f, __header__=np.frombuffer(header.encode(), np.uint8),
             **arrays)


def load(path: str, device=None):
  """Reads a file `save` wrote, or a JAX-package `.joblib` file."""
  from putting_dune_torch import device as device_lib

  device = device_lib.resolve_device(device)
  with open(path, 'rb') as f:
    magic = f.read(2)
  if magic != b'PK':
    return convert(read_records(path), device)
  with np.load(path, allow_pickle=False) as data:
    arrays = {k: data[k] for k in data.files}
  header = json.loads(arrays.pop('__header__').tobytes().decode())
  if header.get('format') != FORMAT:
    raise ValueError(f'{path}: not a file of {FORMAT}')
  node = header['model']
  return REGISTRY[node['class']].from_state_tree(node, arrays, '', device,
                                                 REGISTRY)
