"""`StandardScaler` and the two-step `Pipeline` of the classical learners.

The scaler follows sklearn's: the variance with ddof 0, a column whose
variance is within sklearn's rounding bound of 0 scales by 1 (the recorded
data's current and voltage are constant), and float32 input comes out
float32, computed in float32 with the float64 mean and scale rounded to
float32 first, as sklearn's `transform` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from putting_dune_torch.classifiers import _base

_EPS = float(np.finfo(np.float64).eps)


class StandardScaler(_base.Estimator):

  def fit(self, X, y=None) -> 'StandardScaler':
    x = _base.as_tensor(X, self.device, _base.F64)
    n, self.n_features_in_ = x.shape
    self.n_samples_seen_ = n
    # sklearn's _incremental_mean_and_var from nothing seen.
    self.mean_ = x.sum(dim=0) / n
    temp = x - self.mean_
    correction = temp.sum(dim=0)
    self.var_ = (torch.square(temp).sum(dim=0)
                 - torch.square(correction) / n) / n
    # sklearn's _is_constant_feature: a variance within the rounding of
    # the one-pass update is a constant column.
    bound = n * _EPS * self.var_ + torch.square(n * self.mean_ * _EPS)
    constant = self.var_ <= bound
    self.scale_ = torch.where(constant, torch.ones_like(self.var_),
                              torch.sqrt(self.var_))
    return self

  def transform_tensor(self, X) -> torch.Tensor:
    """In the input's dtype, with mean_ and scale_ cast to it first."""
    out = _base.as_tensor(X, self.device)
    return (out - self.mean_.to(out.dtype)) / self.scale_.to(out.dtype)

  def transform(self, X) -> np.ndarray:
    return _base.host(self.transform_tensor(X))

  def fit_transform(self, X, y=None) -> np.ndarray:
    return self.fit(X).transform(X)


class Pipeline(_base.Classifier):
  """A transformer then a classifier, sklearn's `Pipeline` for two steps."""

  _PARAMS = ('step_names',)

  def __init__(self, steps: Sequence[Tuple[str, object]]):
    self.step_names = tuple(name for name, _ in steps)
    self.step_estimators = [est for _, est in steps]
    self.device = self.step_estimators[-1].device

  @property
  def steps(self):
    return list(zip(self.step_names, self.step_estimators))

  @property
  def classes_(self) -> np.ndarray:
    return self.step_estimators[-1].classes_

  @property
  def n_features_in_(self) -> int:
    return self.step_estimators[0].n_features_in_

  def _transform(self, X) -> torch.Tensor:
    for est in self.step_estimators[:-1]:
      X = est.transform_tensor(X)
    return X

  def fit(self, X, y) -> 'Pipeline':
    for est in self.step_estimators[:-1]:
      X = est.fit(X).transform_tensor(X)
    self.step_estimators[-1].fit(X, y)
    return self

  def predict_proba_tensor(self, X) -> torch.Tensor:
    return self.step_estimators[-1].predict_proba_tensor(self._transform(X))

  def predict(self, X) -> np.ndarray:
    return self.step_estimators[-1].predict(self._transform(X))


def make_pipeline(*estimators) -> Pipeline:
  """sklearn's naming: each step under its lower-cased class name."""
  return Pipeline([(type(est).__name__.lower(), est) for est in estimators])
