"""The learners' files: the JAX package's `.joblib` files read by the port
without sklearn or joblib (`classifiers/joblib_io.py`), and the port's own
`.npz` format.

Each learner type is fitted by the JAX CLI's `get_sklearn_classifier` and
dumped with joblib; the port's reading gives sklearn's `predict_proba`
within 1e-10 and the same `score`; so does the CLI's soft VotingClassifier
file. A pickle that names anything off the whitelist raises before it is
called. The committed fixtures of `scripts/make_classifier_fixtures.py`
(what the card is held to) read back to their recorded probabilities. The
port's own files round-trip.
"""

import ast
import glob
import io
import os
import pathlib
import pickle

import joblib
import numpy as np
import pytest
import torch
from sklearn import ensemble as skensemble
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


@pytest.mark.parametrize('learner', LEARNERS)
def test_the_ports_own_files_round_trip(tmp_path, learner):
  context, y = _recording(4)
  args = t_trl.Args(source_path='', workdir='', epochs=30, device='cpu')
  kwargs = {} if learner in ('knn', 'gp') else {'random_state': 0}
  model = t_trl.get_sklearn_classifier(learner, args, **kwargs)
  model.fit(context, y)
  path = str(tmp_path / f'{learner}_0{joblib_io.SUFFIX}')
  joblib_io.save(model, path)
  back = joblib_io.load(path, device='cpu')
  assert type(back) is type(model)
  q = _grid(context)
  np.testing.assert_array_equal(back.predict_proba(q), model.predict_proba(q))
  np.testing.assert_array_equal(back.classes_, model.classes_)
  # No pickle inside: numpy reads the file with allow_pickle=False.
  with np.load(path, allow_pickle=False) as data:
    assert '__header__' in data.files


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
