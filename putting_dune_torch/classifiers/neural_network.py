"""`MLPClassifier`: sklearn's defaults and its Adam loop, in float64.

ReLU hidden layers (100,), a softmax output (one logistic unit for two
classes) and the log-loss clipped to [eps, 1 - eps], plus
`0.5 * alpha * sum ||W||^2 / batch rows`; Glorot-uniform initial weights
drawn, layer by layer (weights, then biases), from a numpy `RandomState`
as sklearn draws them; batches of `min(200, n)` rows with a short last
one, reshuffled every epoch by the same `RandomState` (sklearn's
`shuffle`); Adam with lr 1e-3, betas 0.9 / 0.999, eps 1e-8 and sklearn's
bias-corrected step size. Training stops when the epoch's loss has not
improved on the best by `tol` for more than 10 epochs in a row, or after
`max_iter` epochs. The forward and backward passes are sklearn's
explicit ones (no autograd), on the device; the loss is read on the host
once an epoch for the stopping rule.
"""

from __future__ import annotations

import numpy as np
import torch

from putting_dune_torch.classifiers import _base
from putting_dune_torch.classifiers import tree as tree_lib

_EPS = float(np.finfo(np.float64).eps)
# sklearn's defaults, which the rate-learner CLI keeps.
HIDDEN = (100,)
MAX_BATCH = 200
LEARNING_RATE = 1e-3
BETA_1, BETA_2, ADAM_EPS = 0.9, 0.999, 1e-8
N_ITER_NO_CHANGE = 10


class MLPClassifier(_base.Classifier):
  _PARAMS = ('alpha', 'max_iter', 'shuffle', 'random_state', 'tol')

  def __init__(self, alpha: float = 1e-4, max_iter: int = 200,
               shuffle: bool = True, random_state=None, tol: float = 1e-4,
               device=None):
    super().__init__(device)
    self.alpha = alpha
    self.max_iter = max_iter
    self.shuffle = shuffle
    self.random_state = random_state
    self.tol = tol

  def _targets(self, encoded: np.ndarray) -> torch.Tensor:
    """sklearn's LabelBinarizer: one column for two classes."""
    if len(self.classes_) == 2:
      cols = encoded[:, None].astype(np.float64)
    else:
      cols = np.eye(len(self.classes_))[encoded]
    return torch.as_tensor(cols, dtype=_base.F64, device=self.device)

  def _forward(self, x: torch.Tensor) -> list:
    acts = [x]
    last = len(self.coefs_) - 1
    for i, (w, b) in enumerate(zip(self.coefs_, self.intercepts_)):
      z = acts[-1] @ w + b
      if i < last:
        z = torch.relu(z)
      elif self.out_activation_ == 'softmax':
        z = torch.exp(z - z.max(dim=1, keepdim=True).values)
        z = z / z.sum(dim=1, keepdim=True)
      else:
        z = torch.sigmoid(z)
      acts.append(z)
    return acts

  def _loss(self, y: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    prob = prob.clamp(_EPS, 1.0 - _EPS)
    rows = prob.shape[0]
    if self.out_activation_ == 'softmax':
      terms = torch.special.xlogy(y, prob)
    else:
      terms = (torch.special.xlogy(y, prob)
               + torch.special.xlogy(1.0 - y, 1.0 - prob))
    return -(terms.sum(dim=0) / rows).sum()

  def fit(self, X, y) -> 'MLPClassifier':
    x = _base.as_tensor(X, self.device, _base.F64)
    self.n_features_in_ = x.shape[1]
    self.classes_, encoded = _base.encode_labels(y)
    if len(self.classes_) < 2:
      raise ValueError('MLPClassifier needs at least two classes')
    targets = self._targets(encoded)
    n = x.shape[0]
    self.out_activation_ = ('softmax' if len(self.classes_) > 2
                            else 'logistic')
    rng = tree_lib.check_random_state(self.random_state)
    units = [x.shape[1], *HIDDEN, targets.shape[1]]
    self.coefs_, self.intercepts_ = [], []
    for fan_in, fan_out in zip(units[:-1], units[1:]):
      bound = np.sqrt(6.0 / (fan_in + fan_out))
      coef = rng.uniform(-bound, bound, (fan_in, fan_out))
      intercept = rng.uniform(-bound, bound, fan_out)
      self.coefs_.append(torch.as_tensor(coef, device=self.device))
      self.intercepts_.append(torch.as_tensor(intercept, device=self.device))
    # sklearn keeps the initial weights as its best ones when it does not
    # stop early; `joblib_io.dump` writes them, with the optimiser's state.
    self._best_coefs = [c.clone() for c in self.coefs_]
    self._best_intercepts = [b.clone() for b in self.intercepts_]
    params = self.coefs_ + self.intercepts_
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    batch = min(MAX_BATCH, n)
    sample_idx = np.arange(n)
    self.loss_curve_, self.best_loss_ = [], np.inf
    self.n_iter_, no_improvement, step = 0, 0, 0
    nl = len(self.coefs_)
    for _ in range(self.max_iter):
      if self.shuffle:
        perm = np.arange(n)
        rng.shuffle(perm)
        sample_idx = sample_idx[perm]
        order = torch.as_tensor(sample_idx, device=self.device)
      accumulated = torch.zeros((), dtype=_base.F64, device=self.device)
      for sl in _base.chunks(n, batch):
        if self.shuffle:
          xb, yb = x[order[sl]], targets[order[sl]]
        else:
          xb, yb = x[sl], targets[sl]
        rows = xb.shape[0]
        acts = self._forward(xb)
        sq = sum(torch.dot(w.reshape(-1), w.reshape(-1)) for w in self.coefs_)
        loss = self._loss(yb, acts[-1]) + (0.5 * self.alpha) * sq / rows
        accumulated += loss * rows
        delta = acts[-1] - yb
        coef_grads, inter_grads = [None] * nl, [None] * nl
        for i in range(nl - 1, -1, -1):
          coef_grads[i] = (acts[i].T @ delta
                           + self.alpha * self.coefs_[i]) / rows
          inter_grads[i] = delta.sum(dim=0) / rows
          if i:
            delta = (delta @ self.coefs_[i].T) * (acts[i] != 0)
        step += 1
        lr = (LEARNING_RATE * np.sqrt(1 - BETA_2**step)
              / (1 - BETA_1**step))
        for p, m, v, g in zip(params, ms, vs, coef_grads + inter_grads):
          m.mul_(BETA_1).add_((1 - BETA_1) * g)
          v.mul_(BETA_2).add_((1 - BETA_2) * torch.square(g))
          p.add_(-lr * m / (torch.sqrt(v) + ADAM_EPS))
      self.n_iter_ += 1
      self.loss_ = float(accumulated) / n
      self.loss_curve_.append(self.loss_)
      if self.loss_ > self.best_loss_ - self.tol:
        no_improvement += 1
      else:
        no_improvement = 0
      if self.loss_ < self.best_loss_:
        self.best_loss_ = self.loss_
      if no_improvement > N_ITER_NO_CHANGE:
        break
    self.best_loss_ = float(self.best_loss_)
    self.t_ = n * self.n_iter_
    self._no_improvement_count = no_improvement
    self._random_state = rng
    self._adam = {'t': step, 'learning_rate': lr, 'ms': ms, 'vs': vs}
    return self

  def predict_proba_tensor(self, X) -> torch.Tensor:
    out = self._forward(_base.as_tensor(X, self.device, _base.F64))[-1]
    if self.out_activation_ == 'logistic':
      return torch.cat([1.0 - out, out], dim=1)
    return out
