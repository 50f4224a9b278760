"""The port's classical learners (`putting_dune_torch/classifiers/`) held
against sklearn 1.9 on the same seeded data (5 features, 4 classes unless
said), on the CPU.

- StandardScaler: its statistics within 1e-12 (relative for the column
  of variance ~1e4), the transform within 1e-12 (float32 input comes out
  float32);
- KNN: predict_proba equal on continuous data;
- a single tree with all features and no bootstrap: the same feature,
  threshold and value at every node, predict_proba equal; the forest too
  (it seeds and bootstraps as sklearn's does), and its law below;
- MLP from sklearn's initial weights (the same RandomState draws) without
  shuffling: coefs_ within 1e-8, loss_curve_ within 1e-10, the same
  n_iter_;
- binary SVC (probability=False): the dual objective within 1e-3
  relative, decision values within 1e-2, at least 99.5% of the
  predictions equal; the Platt fit within 1e-4 of sklearn's
  `_sigmoid_calibration` on the same decision values;
- GP: optimizer=None predict_proba within 1e-8; with the optimiser log
  theta within 1e-3 and predict_proba within 1e-4;
- in law over 20 seeds (the forest, the SVC's probabilities, the shuffled
  MLP): test accuracy and log-loss, the mean paired difference within 3
  standard errors.
"""

import numpy as np
import pytest
import torch
from sklearn import ensemble as skensemble
from sklearn import gaussian_process as skgp
from sklearn import neighbors as skneighbors
from sklearn import neural_network as sknn
from sklearn import preprocessing as skpreprocessing
from sklearn import svm as sksvm
from sklearn import tree as sktree
from sklearn.calibration import _sigmoid_calibration

from putting_dune_torch.classifiers import ensemble
from putting_dune_torch.classifiers import gaussian_process
from putting_dune_torch.classifiers import neighbors
from putting_dune_torch.classifiers import neural_network
from putting_dune_torch.classifiers import preprocessing
from putting_dune_torch.classifiers import svm
from putting_dune_torch.classifiers import tree

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings('ignore::UserWarning',
                                        'ignore::RuntimeWarning')


def _data(seed, n, classes=4, dtype=np.float64):
  """Continuous features; labels from a noisy rule on two of them."""
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(n, 5))
  score = x[:, 1] + 0.5 * rng.normal(size=n)
  y = (score > 0).astype(np.int64)
  if classes == 4:
    y = y + 2 * (x[:, 2] + 0.5 * rng.normal(size=n) > 0.3)
  return x.astype(dtype), y


def _queries(seed, n=300):
  return np.random.default_rng(seed + 1000).normal(size=(n, 5))


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_standard_scaler_matches_sklearn(dtype):
  x, _ = _data(0, 200, dtype=dtype)
  x[:, 0] = 3.0  # a constant column scales by 1
  x[:, 3] *= 100.0
  sk = skpreprocessing.StandardScaler().fit(x)
  pt = preprocessing.StandardScaler(device='cpu').fit(x)
  for name in ('mean_', 'var_', 'scale_'):
    np.testing.assert_allclose(getattr(pt, name).numpy(),
                               getattr(sk, name), rtol=1e-12, atol=1e-12)
  assert float(pt.scale_[0]) == 1.0 == sk.scale_[0]
  got, want = pt.transform(x), sk.transform(x)
  assert got.dtype == want.dtype == dtype
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize('seed', [0, 1])
def test_knn_predict_proba_equals_sklearn(seed):
  x, y = _data(seed, 300)
  q = _queries(seed)
  sk = skneighbors.KNeighborsClassifier(25).fit(x, y)
  pt = neighbors.KNeighborsClassifier(25, device='cpu').fit(x, y)
  np.testing.assert_array_equal(pt.predict_proba(q), sk.predict_proba(q))
  np.testing.assert_array_equal(pt.predict(q), sk.predict(q))
  assert pt.score(x, y) == sk.score(x, y)


def _same_tree(pt_tree, sk_tree):
  t = sk_tree.tree_
  assert pt_tree.node_count == t.node_count
  np.testing.assert_array_equal(pt_tree.feature.numpy(), t.feature)
  np.testing.assert_array_equal(pt_tree.threshold.numpy(), t.threshold)
  np.testing.assert_array_equal(pt_tree.children_left.numpy(),
                                t.children_left)
  np.testing.assert_array_equal(pt_tree.value.numpy(), t.value[:, 0])


@pytest.mark.parametrize('max_depth', [5, None])
def test_single_tree_equals_sklearn_node_by_node(max_depth):
  x, y = _data(2, 400)
  sk = sktree.DecisionTreeClassifier(max_depth=max_depth,
                                     random_state=3).fit(x, y)
  pt = tree.DecisionTreeClassifier(max_depth=max_depth, random_state=3,
                                   device='cpu').fit(x, y)
  _same_tree(pt, sk)
  q = _queries(2)
  np.testing.assert_array_equal(pt.predict_proba(q), sk.predict_proba(q))


def test_forest_equals_sklearn_tree_by_tree():
  x, y = _data(3, 300, dtype=np.float32)
  x[:, 0] = 1.0  # sqrt of 5 features: constant draws happen
  sk = skensemble.RandomForestClassifier(max_depth=5, n_estimators=10,
                                         random_state=7).fit(x, y)
  pt = ensemble.RandomForestClassifier(max_depth=5, n_estimators=10,
                                       random_state=7, device='cpu').fit(x, y)
  for a, b in zip(pt.estimators_, sk.estimators_):
    _same_tree(a, b)
  q = _queries(3)
  np.testing.assert_allclose(pt.predict_proba(q), sk.predict_proba(q),
                             rtol=0, atol=1e-15)


@pytest.mark.parametrize('classes', [4, 2])
def test_mlp_from_sklearns_initial_weights_follows_its_curve(classes):
  x, y = _data(4, 250, classes)
  kw = dict(alpha=0.1, max_iter=200, random_state=5, shuffle=False)
  sk = sknn.MLPClassifier(**kw).fit(x, y)
  pt = neural_network.MLPClassifier(device='cpu', **kw).fit(x, y)
  assert pt.n_iter_ == sk.n_iter_
  for a, b in zip(pt.coefs_, sk.coefs_):
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-8)
  np.testing.assert_allclose(pt.loss_curve_, sk.loss_curve_, rtol=0,
                             atol=1e-10)
  q = _queries(4)
  np.testing.assert_allclose(pt.predict_proba(q), sk.predict_proba(q),
                             rtol=0, atol=1e-8)


def test_mlp_stops_as_sklearn_when_the_loss_stalls():
  x, y = _data(5, 120)
  kw = dict(alpha=0.1, max_iter=500, random_state=0, shuffle=False,
            tol=1e-2)
  sk = sknn.MLPClassifier(**kw).fit(x, y)
  pt = neural_network.MLPClassifier(device='cpu', **kw).fit(x, y)
  assert pt.n_iter_ == sk.n_iter_ < 500


def _dual_objective(support_vectors, coef, gamma):
  d2 = ((support_vectors[:, None] - support_vectors[None]) ** 2).sum(-1)
  k = np.exp(-gamma * d2)
  return 0.5 * coef @ k @ coef - np.abs(coef).sum()


@pytest.mark.parametrize('seed', [6, 7])
def test_binary_svc_matches_libsvm(seed):
  x, y = _data(seed, 300, 2)
  sk = sksvm.SVC(gamma=2, C=1).fit(x, y)
  pt = svm.SVC(gamma=2, C=1, device='cpu').fit(x, y)
  want = _dual_objective(sk.support_vectors_, sk._dual_coef_[0], 2.0)
  got = _dual_objective(pt.support_vectors_.numpy(), pt.dual_coef.numpy()[0],
                        2.0)
  assert abs(got - want) <= 1e-3 * abs(want)
  q = _queries(seed, 1000)
  np.testing.assert_allclose(pt.decision_function(q), sk.decision_function(q),
                             rtol=0, atol=1e-2)
  assert np.mean(pt.predict(q) == sk.predict(q)) >= 0.995
  dec = sk.decision_function(x)
  a, b = _sigmoid_calibration(dec, y)
  pa, pb = svm.sigmoid_train(torch.as_tensor(dec),
                             torch.as_tensor(np.where(y == 1, 1.0, -1.0)))
  assert abs(pa - a) <= 1e-4 and abs(pb - b) <= 1e-4


def test_svc_probabilities_couple_libsvms_pairwise_sigmoids():
  # sklearn's probA_ / probB_ through the port's coupling: sklearn's
  # predict_proba (the fitted pair models are equal, as above).
  x, y = _data(8, 240)
  sk = sksvm.SVC(gamma=2, C=1, probability=True, random_state=0).fit(x, y)
  pt = svm.SVC(gamma=2, C=1, probability=True, random_state=0,
               device='cpu').fit(x, y)
  pt.prob_a = torch.as_tensor(sk._probA)
  pt.prob_b = torch.as_tensor(sk._probB)
  q = _queries(8)
  np.testing.assert_allclose(pt.predict_proba(q), sk.predict_proba(q),
                             rtol=0, atol=1e-3)
  np.testing.assert_array_equal(pt.predict(q), sk.predict(q))


@pytest.mark.parametrize('classes', [4, 2])
def test_gp_without_the_optimiser_matches_sklearn(classes):
  x, y = _data(9, 150, classes)
  kernel = 1.0 * skgp.kernels.RBF(1.0)
  sk = skgp.GaussianProcessClassifier(kernel, optimizer=None).fit(x, y)
  pt = gaussian_process.GaussianProcessClassifier(optimizer=None,
                                                  device='cpu').fit(x, y)
  q = _queries(9)
  np.testing.assert_allclose(pt.predict_proba(q), sk.predict_proba(q),
                             rtol=0, atol=1e-8)
  np.testing.assert_array_equal(pt.predict(q), sk.predict(q))


@pytest.mark.parametrize('classes', [4, 2])
def test_gp_fits_sklearns_hyperparameters(classes):
  x, y = _data(10, 120, classes)
  kernel = 1.0 * skgp.kernels.RBF(1.0)
  sk = skgp.GaussianProcessClassifier(kernel).fit(x, y)
  pt = gaussian_process.GaussianProcessClassifier(device='cpu').fit(x, y)
  binaries = (sk.base_estimator_.estimators_ if classes > 2
              else [sk.base_estimator_])
  for a, b in zip(pt.estimators_, binaries):
    np.testing.assert_allclose(np.log(a.scales), b.kernel_.theta, rtol=0,
                               atol=1e-3)
  q = _queries(10)
  np.testing.assert_allclose(pt.predict_proba(q), sk.predict_proba(q),
                             rtol=0, atol=1e-4)


# --- in law ---------------------------------------------------------------------

SEEDS = range(20)


def _log_loss(proba, y, classes):
  p = np.clip(proba[np.arange(len(y)), np.searchsorted(classes, y)], 1e-15,
              1.0)
  return float(-np.log(p).mean())


def _paired_z(a, b):
  d = np.asarray(a) - np.asarray(b)
  se = d.std(ddof=1) / np.sqrt(len(d))
  return abs(d.mean()) / se if se > 0 else (0.0 if d.mean() == 0 else np.inf)


@pytest.mark.parametrize('learner', ['forest', 'svc', 'mlp'])
def test_randomised_learners_agree_with_sklearn_in_law(learner):
  metrics = {'acc': ([], []), 'loss': ([], [])}
  for seed in SEEDS:
    x, y = _data(100 + seed, 160)
    xt, yt = _data(200 + seed, 200)
    if learner == 'forest':
      sk = skensemble.RandomForestClassifier(max_depth=5, n_estimators=10,
                                             random_state=seed)
      pt = ensemble.RandomForestClassifier(max_depth=5, n_estimators=10,
                                           random_state=seed, device='cpu')
    elif learner == 'svc':
      sk = sksvm.SVC(gamma=2, C=1, probability=True, random_state=seed)
      pt = svm.SVC(gamma=2, C=1, probability=True, random_state=seed,
                   device='cpu')
    else:
      sk = sknn.MLPClassifier(alpha=0.1, max_iter=60, random_state=seed)
      pt = neural_network.MLPClassifier(alpha=0.1, max_iter=60,
                                        random_state=seed, device='cpu')
    for model, slot in ((sk, 0), (pt, 1)):
      model.fit(x, y)
      metrics['acc'][slot].append(model.score(xt, yt))
      metrics['loss'][slot].append(
          _log_loss(model.predict_proba(xt), yt, model.classes_))
  for name, (a, b) in metrics.items():
    assert _paired_z(a, b) < 3.0, (name, np.mean(a), np.mean(b))


def test_classes_missing_from_a_bootstrap_are_not_columns():
  x, y = _data(11, 100)
  keep = y != 2
  for model in (neighbors.KNeighborsClassifier(5, device='cpu'),
                ensemble.RandomForestClassifier(n_estimators=3, max_depth=3,
                                                random_state=0,
                                                device='cpu'),
                svm.SVC(gamma=2, probability=True, random_state=0,
                        device='cpu')):
    model.fit(x[keep], y[keep])
    np.testing.assert_array_equal(model.classes_, [0, 1, 3])
    assert model.predict_proba(_queries(11, 7)).shape == (7, 3)


def test_pipeline_standardises_then_classifies_as_sklearn():
  x, y = _data(12, 200, dtype=np.float32)
  x[:, 0] = 60.0
  sk = skpreprocessing.StandardScaler()
  sk_knn = skneighbors.KNeighborsClassifier(25).fit(sk.fit_transform(x), y)
  pt = preprocessing.make_pipeline(
      preprocessing.StandardScaler(device='cpu'),
      neighbors.KNeighborsClassifier(25, device='cpu')).fit(x, y)
  assert [name for name, _ in pt.steps] == ['standardscaler',
                                            'kneighborsclassifier']
  q = _queries(12).astype(np.float32)
  np.testing.assert_array_equal(pt.predict_proba(q),
                                sk_knn.predict_proba(sk.transform(q)))
  assert pt.score(x, y) == sk_knn.score(sk.transform(x), y)
