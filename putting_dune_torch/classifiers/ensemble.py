"""`RandomForestClassifier` and the soft `VotingClassifier`.

The forest seeds its trees as sklearn's does (one `randint(2**31 - 1)` of
the forest's `random_state` a tree), draws each tree's bootstrap with
`RandomState(tree seed).randint(0, n, n)` and passes the draws to the tree
as sample weights (their counts), not as repeated rows: the counts change
both the impurities and the leaf fractions. `predict_proba` is the mean of
the trees'.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from putting_dune_torch.classifiers import _base
from putting_dune_torch.classifiers import tree as tree_lib


class RandomForestClassifier(_base.Classifier):
  _PARAMS = ('n_estimators', 'max_depth', 'random_state')

  def __init__(self, n_estimators: int = 100,
               max_depth: Optional[int] = None, random_state=None,
               device=None):
    super().__init__(device)
    self.n_estimators = n_estimators
    self.max_depth = max_depth
    self.random_state = random_state

  def fit(self, X, y) -> 'RandomForestClassifier':
    x = _base.as_tensor(X, self.device, _base.F32)
    self.classes_, encoded = _base.encode_labels(y)
    y_t = torch.as_tensor(encoded, device=self.device)
    n, self.n_features_in_ = x.shape
    rng = tree_lib.check_random_state(self.random_state)
    seeds = [rng.randint(np.iinfo(np.int32).max)
             for _ in range(self.n_estimators)]
    self.estimators_ = []
    for seed in seeds:
      est = tree_lib.DecisionTreeClassifier(
          max_depth=self.max_depth, max_features='sqrt',
          random_state=int(seed), device=self.device)
      draws = np.random.RandomState(seed).randint(0, n, n)
      weights = np.bincount(draws, minlength=n).astype(np.float64)
      est.classes_ = self.classes_
      est.build(x, y_t, torch.as_tensor(weights, device=self.device),
                len(self.classes_),
                np.random.RandomState(seed).randint(0, tree_lib.RAND_R_MAX))
      self.estimators_.append(est)
    return self

  def predict_proba_tensor(self, X) -> torch.Tensor:
    x = _base.as_tensor(X, self.device, _base.F32)
    total = self.estimators_[0].predict_proba_tensor(x)
    for est in self.estimators_[1:]:
      total = total + est.predict_proba_tensor(x)
    return total / len(self.estimators_)


class VotingClassifier(_base.Classifier):
  """Soft voting over fitted estimators: the mean of their
  `predict_proba` (sklearn's with no weights). As the rate-learner CLI
  builds it, the fitted estimators are given, not fitted here; `classes_`
  is the first estimator's."""

  _PARAMS = ('names',)

  def __init__(self, estimators: Sequence[Tuple[str, object]]):
    self.names = tuple(name for name, _ in estimators)
    self.estimators_ = [est for _, est in estimators]
    self.device = self.estimators_[0].device

  @property
  def classes_(self) -> np.ndarray:
    return self.estimators_[0].classes_

  @property
  def n_features_in_(self) -> int:
    return self.estimators_[0].n_features_in_

  def predict_proba_tensor(self, X) -> torch.Tensor:
    probas = [est.predict_proba_tensor(X) for est in self.estimators_]
    return torch.stack(probas).mean(dim=0)
