"""`KNeighborsClassifier` with uniform weights: brute-force squared
distances (summed feature by feature, as the KD tree sums them) and `topk`
on the device, in float64."""

from __future__ import annotations

import torch

from putting_dune_torch.classifiers import _base

# Rows of queries a pass: a (rows, n_train) float64 block of ~256 MB.
_BLOCK_ELEMENTS = 2**25


class KNeighborsClassifier(_base.Classifier):
  _PARAMS = ('n_neighbors',)

  def __init__(self, n_neighbors: int = 5, device=None):
    super().__init__(device)
    self.n_neighbors = n_neighbors

  def fit(self, X, y) -> 'KNeighborsClassifier':
    self._fit_X = _base.as_tensor(X, self.device, _base.F64)
    self.n_features_in_ = self._fit_X.shape[1]
    self.classes_, encoded = _base.encode_labels(y)
    if self.n_neighbors > self._fit_X.shape[0]:
      raise ValueError(f'n_neighbors={self.n_neighbors} is more than the '
                       f'{self._fit_X.shape[0]} fitted samples')
    self._y = torch.as_tensor(encoded, device=self.device)
    return self

  def _neighbors(self, X) -> torch.Tensor:
    """The indices of the n_neighbors nearest fitted rows, nearest
    first."""
    x = _base.as_tensor(X, self.device, _base.F64)
    rows = max(1, _BLOCK_ELEMENTS // max(1, self._fit_X.shape[0]))
    return torch.cat([
        torch.topk(_base.squared_distances(x[block], self._fit_X),
                   self.n_neighbors, dim=1, largest=False, sorted=True)[1]
        for block in _base.chunks(x.shape[0], rows)])

  def predict_proba_tensor(self, X) -> torch.Tensor:
    idx = self._neighbors(X)
    labels = self._y[idx]
    counts = torch.zeros((idx.shape[0], len(self.classes_)),
                         dtype=_base.F64, device=self.device)
    counts.scatter_add_(1, labels, torch.ones_like(labels, dtype=_base.F64))
    return counts / self.n_neighbors
