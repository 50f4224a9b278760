"""The learners' files, read and written by the port without sklearn or
joblib (`classifiers/joblib_io.py`).

Each learner type is fitted by the JAX CLI's `get_sklearn_classifier` and
dumped with joblib; the port's reading gives sklearn's `predict_proba`
within 1e-10 and the same `score`; so does the CLI's soft VotingClassifier
file. A pickle that names anything off the whitelist raises before it is
called. The committed fixtures of `scripts/make_classifier_fixtures.py`
(what the card is held to) read back to their recorded probabilities.

The other way: the port fits each type (and the soft ensemble), writes
`.joblib` with `joblib_io.dump`, and sklearn's `joblib.load` (no version
warning) gives `predict_proba` within 1e-10 of the port's and the same
`score`; the port's reader reads the file back to equal probabilities.
Each written object holds the attributes sklearn's own file holds (the
committed fixtures), and the KNN's KD tree is the one sklearn's `KDTree`
builds.
"""

import ast
import glob
import io
import os
import pathlib
import pickle

import warnings

import joblib
import numpy as np
import pytest
import torch
from sklearn import ensemble as skensemble
from sklearn import neighbors as skneighbors
from sklearn import svm as sksvm

from putting_dune_torch.classifiers import joblib_io
from putting_dune_torch.pipeline import train_rate_learner as t_trl
from putting_dune_tpu.pipeline import train_rate_learner as j_trl

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::FutureWarning',
                                        'ignore::RuntimeWarning')

LEARNERS = ('sklearn_mlp', 'knn', 'gp', 'random_forest', 'svm')
FIXTURES = (pathlib.Path(__file__).resolve().parent / 'data'
            / 'torch_classifiers')
TOL = 1e-10
REPO = FIXTURES.parent.parent.parent


def _recording(seed=0, n=160):
  """Rows shaped as the CLI's classical input: constant current and
  voltage, the dwell column, the canonical beam position; float32."""
  rng = np.random.default_rng(seed)
  context = np.zeros((n, 5), np.float32)
  context[:, 0], context[:, 1], context[:, 2] = 0.1, 60.0, 5.0
  context[:, 3:] = rng.normal(size=(n, 2)) * 1.5
  d = np.linalg.norm(context[:, 3:] - [1.0, 0.0], axis=1)
  y = np.where(rng.random(n) < np.exp(-d), rng.integers(1, 4, n), 0)
  return context, y.astype(np.int32)


def _grid(context, n=400):
  rng = np.random.default_rng(99)
  q = np.repeat(context[:1].astype(np.float64), n, axis=0)
  q[:, 3:] = rng.uniform(-4, 4, (n, 2))
  return q


@pytest.mark.parametrize('learner', LEARNERS)
def test_jax_joblib_file_reads_to_sklearns_probabilities(tmp_path, learner):
  context, y = _recording()
  args = j_trl.Args(source_path='', workdir='', epochs=40)
  model = j_trl.get_sklearn_classifier(learner, args)
  model.fit(context, y)
  path = str(tmp_path / f'{learner}_0.joblib')
  joblib.dump(model, path)
  port = joblib_io.load(path, device='cpu')
  q = _grid(context)
  np.testing.assert_allclose(port.predict_proba(q), model.predict_proba(q),
                             rtol=0, atol=TOL)
  np.testing.assert_array_equal(port.classes_, model.classes_)
  assert port.score(context, y) == model.score(context, y)


def test_jax_ensemble_file_reads_to_the_clis_rates(tmp_path):
  context, y = _recording(1)
  args = j_trl.Args(source_path='', workdir='', epochs=40)
  models = [j_trl.get_sklearn_classifier(lt, args).fit(context, y)
            for lt in ('knn', 'random_forest', 'svm')]
  ens = skensemble.VotingClassifier(
      [(f'm_{i}', m) for i, m in enumerate(models)], voting='soft')
  ens.estimators_ = models
  ens.le_ = None
  path = str(tmp_path / 'ensemble.joblib')
  joblib.dump(ens, path)
  port = joblib_io.load(path, device='cpu')
  q = _grid(context)
  np.testing.assert_allclose(port.predict_proba(q), ens.predict_proba(q),
                             rtol=0, atol=TOL)
  # The CLI's rate function: the mean of predict_proba[..., 1:].
  want = np.mean([m.predict_proba(q)[..., 1:] for m in models], axis=0)
  got = np.mean([m.predict_proba(q)[..., 1:] for m in port.estimators_],
                axis=0)
  np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


class _Called(Exception):
  pass


def _boom(*args):
  raise _Called(args)


class _Evil:
  def __reduce__(self):
    return (_boom, ('called',))


@pytest.mark.parametrize('payload', [
    lambda: pickle.dumps(_Evil()),
    lambda: pickle.dumps(os.system),
    lambda: pickle.dumps({'steps': [('a', _Evil())]}),
], ids=['callable', 'os.system', 'nested'])
def test_pickles_naming_classes_off_the_whitelist_raise_uncalled(payload):
  with pytest.raises(pickle.UnpicklingError, match='whitelist'):
    joblib_io.RestrictedUnpickler(io.BytesIO(payload())).load()


def test_an_sklearn_class_off_the_whitelist_raises(tmp_path):
  context, y = _recording(2)
  path = str(tmp_path / 'nusvc.joblib')
  joblib.dump(sksvm.NuSVC(nu=0.05).fit(context, y), path)
  with pytest.raises(pickle.UnpicklingError, match='NuSVC.*whitelist'):
    joblib_io.load(path, device='cpu')


def test_compressed_joblib_files_are_refused(tmp_path):
  context, y = _recording(3)
  path = str(tmp_path / 'knn.joblib')
  model = j_trl.get_sklearn_classifier(
      'knn', j_trl.Args(source_path='', workdir=''))
  joblib.dump(model.fit(context, y), path, compress=3)
  with pytest.raises(ValueError, match='uncompressed'):
    joblib_io.load(path, device='cpu')


@pytest.mark.parametrize('learner', LEARNERS + ('ensemble',))
def test_committed_fixtures_read_to_their_recorded_probabilities(learner):
  q = np.load(FIXTURES / 'queries.npy')
  port = joblib_io.load(str(FIXTURES / f'{learner}.joblib'), device='cpu')
  np.testing.assert_allclose(port.predict_proba(q),
                             np.load(FIXTURES / f'{learner}_proba.npy'),
                             rtol=0, atol=TOL)


def _port_learner(learner, context, y, seed=0):
  args = t_trl.Args(source_path='', workdir='', epochs=30, device='cpu')
  if learner == 'ensemble':
    # The CLI's soft vote over its bootstrap models (here two forests).
    from putting_dune_torch.classifiers import ensemble as t_ensemble

    models = [_port_learner('random_forest', context, y, seed + i)
              for i in range(2)]
    return t_ensemble.VotingClassifier(
        [(f'random_forest_{i}', m) for i, m in enumerate(models)])
  kwargs = {} if learner in ('knn', 'gp') else {'random_state': seed}
  return t_trl.get_sklearn_classifier(learner, args, **kwargs).fit(context,
                                                                   y)


def _sklearn_load(path):
  """joblib.load with sklearn's warnings (InconsistentVersionWarning
  among them) raised."""
  with warnings.catch_warnings():
    warnings.simplefilter('error')
    return joblib.load(path)


def _score(model, x, y):
  """sklearn's `score`; the CLI's ensemble has no label encoder (`le_` is
  None, as the JAX CLI sets it), so its accuracy is that of the argmax of
  `predict_proba`."""
  if isinstance(model, skensemble.VotingClassifier) or hasattr(
      model, 'names'):
    proba = model.predict_proba(x)
    classes = model.estimators_[0].classes_
    return float(np.mean(classes[np.argmax(proba, axis=1)] == y))
  return model.score(x, y)


@pytest.mark.parametrize('learner', LEARNERS + ('ensemble',))
def test_the_ports_own_files_round_trip(tmp_path, learner):
  context, y = _recording(4)
  model = _port_learner(learner, context, y)
  path = str(tmp_path / f'{learner}_0{joblib_io.SUFFIX}')
  joblib_io.dump(model, path)
  q = _grid(context)
  sk = _sklearn_load(path)
  np.testing.assert_allclose(sk.predict_proba(q), model.predict_proba(q),
                             rtol=0, atol=TOL)
  assert _score(sk, context, y) == _score(model, context, y)
  back = joblib_io.load(path, device='cpu')
  assert type(back) is type(model)
  np.testing.assert_array_equal(back.predict_proba(q), model.predict_proba(q))
  np.testing.assert_array_equal(back.classes_, model.classes_)
  # What the reader read is written again as sklearn loads it.
  joblib_io.dump(back, str(tmp_path / 'again.joblib'))
  np.testing.assert_array_equal(
      _sklearn_load(str(tmp_path / 'again.joblib')).predict_proba(q),
      sk.predict_proba(q))


@pytest.mark.parametrize('learner', ['sklearn_mlp', 'gp', 'svm'])
def test_two_class_files_load_in_sklearn(tmp_path, learner):
  """sklearn's two-class forms: one logistic output, one Laplace
  classifier of the labels, libsvm's sign flip."""
  context, y = _recording(5)
  y = np.where(y > 0, 7, 2).astype(np.int32)
  model = _port_learner(learner, context, y)
  path = str(tmp_path / f'{learner}.joblib')
  joblib_io.dump(model, path)
  sk = _sklearn_load(path)
  q = _grid(context)
  np.testing.assert_allclose(sk.predict_proba(q), model.predict_proba(q),
                             rtol=0, atol=TOL)
  np.testing.assert_array_equal(sk.predict(q), model.predict(q))
  assert sk.score(context, y) == model.score(context, y)


def _attributes(rec, out, seen=None):
  """{class path: attribute names} over a record tree."""
  if isinstance(rec, joblib_io.Record):
    if isinstance(rec.state, dict):
      out.setdefault(rec.path, set()).update(rec.state)
    for value in (rec.state.values() if isinstance(rec.state, dict)
                  else rec.state or ()):
      _attributes(value, out)
  elif isinstance(rec, (list, tuple)):
    for value in rec:
      _attributes(value, out)
  return out


@pytest.mark.parametrize('learner', LEARNERS + ('ensemble',))
def test_written_files_hold_what_sklearns_files_hold(tmp_path, learner):
  context, y = _recording(6)
  path = str(tmp_path / f'{learner}.joblib')
  joblib_io.dump(_port_learner(learner, context, y), path)
  want = _attributes(joblib_io.read_records(
      str(FIXTURES / f'{learner}.joblib')), {})
  got = _attributes(joblib_io.read_records(path), {})
  assert got == want


def test_the_kd_tree_is_the_one_sklearn_builds():
  data = np.random.default_rng(7).standard_normal((301, 5))
  ours = joblib_io.kd_tree_state(data)
  theirs = skneighbors.KDTree(data, leaf_size=30).__getstate__()
  # leaf size, levels, nodes (the build's counters are 0 in both).
  assert ours[4:11] == tuple(theirs[4:11])
  np.testing.assert_array_equal(ours[0], theirs[0])
  np.testing.assert_array_equal(ours[3], theirs[3])
  for name in ('idx_start', 'idx_end', 'is_leaf'):
    np.testing.assert_array_equal(ours[2][name], theirs[2][name])
  np.testing.assert_allclose(ours[2]['radius'], theirs[2]['radius'],
                             rtol=1e-15)
  for start, end in zip(ours[2]['idx_start'], ours[2]['idx_end']):
    assert set(ours[1][start:end]) == set(theirs[1][start:end])


def test_fixture_versions_are_recorded():
  assert sorted(os.path.basename(p) for p in glob.glob(
      str(FIXTURES / '*.joblib'))) == sorted(
          f'{name}.joblib' for name in LEARNERS + ('ensemble',))
  assert (FIXTURES / 'versions.json').exists()


def test_the_port_imports_neither_joblib_nor_sklearn():
  sources = sorted((REPO / 'putting_dune_torch').rglob('*.py'))
  sources.append(REPO / 'chip_smoke.py')
  for path in sources:
    for node in ast.walk(ast.parse(path.read_text())):
      if isinstance(node, ast.Import):
        names = [alias.name for alias in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or '']
      else:
        continue
      for name in names:
        assert name.split('.')[0] not in ('joblib', 'sklearn', 'cv2', 'PIL'), (
            f'{path.relative_to(REPO)}:{node.lineno} imports {name}')
