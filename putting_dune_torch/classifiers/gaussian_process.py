"""`GaussianProcessClassifier(1.0 * RBF(1.0))`: sklearn's Laplace
classifier, its linear algebra in float64 on the device.

Each class gets a binary Laplace classifier (one against the rest,
probabilities normalised over the classes; two classes need one):
Rasmussen and Williams' Algorithm 3.1 for the posterior mode, Newton
started from zero at every evaluation and stopped when the log marginal
likelihood gains less than 1e-10; Algorithm 5.1 for its gradient in log
theta (theta = the constant and the length scale); Algorithm 3.2 with
sklearn's erf-series approximation of the probit integral for the
probabilities. The hyperparameters are fitted by `scipy.optimize.minimize
(method='L-BFGS-B')` on the host from log theta = 0 within log 1e-5 and
log 1e5, the objective and its gradient computed on the device, as
sklearn does it. The kernel's squared distances are summed feature by
feature as scipy's `pdist` sums them. A fitted classifier keeps its
kernel as sklearn's does: the scales (c, l), not their logarithms.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from putting_dune_torch.classifiers import _base

LAMBDAS = torch.tensor([0.41, 0.4, 0.37, 0.44, 0.39], dtype=torch.float64)
COEFS = torch.tensor([-1854.8214151, 3516.89893646, 221.29346712,
                      128.12323805, -2010.49422654], dtype=torch.float64)
BOUNDS = (math.log(1e-5), math.log(1e5))
MAX_NEWTON_STEPS = 100  # sklearn's max_iter_predict
# Query rows a pass: a (n_train, rows) float64 block of ~256 MB.
_BLOCK_ELEMENTS = 2**25


def scales_of(theta) -> tuple:
  """(c, l) = exp(theta), as sklearn's fitted kernel holds them."""
  return math.exp(float(theta[0])), math.exp(float(theta[1]))


def kernel(scales, a: torch.Tensor, b: Optional[torch.Tensor] = None,
           eval_gradient: bool = False):
  """ConstantKernel(c) * RBF(l) at scales = (c, l): K(a, b), and with
  eval_gradient (b None) the gradient in log theta = (log c, log l), a
  list of two."""
  c, length = scales
  xa = a / length
  d2 = _base.squared_distances(xa, xa if b is None else b / length)
  rbf = torch.exp(-0.5 * d2)
  k = c * rbf
  if not eval_gradient:
    return k
  return k, [c * rbf, (rbf * d2) * c]


def probit_average(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
  """sklearn's approximation of E[sigmoid(f)], f ~ N(mean, var)."""
  lam = LAMBDAS.to(mean.device)[:, None]
  coefs = COEFS.to(mean.device)[:, None]
  alpha = 1 / (2 * var)
  gamma = lam * mean
  integrals = (torch.sqrt(math.pi / alpha)
               * torch.erf(gamma * torch.sqrt(alpha / (alpha + lam**2)))
               / (2 * torch.sqrt(var * 2 * math.pi)))
  return (coefs * integrals).sum(dim=0) + 0.5 * coefs.sum()


class BinaryLaplace(_base.Classifier):
  """One binary classifier (sklearn's `_BinaryGaussianProcessClassifier
  Laplace`); y_train_ holds 0 / 1."""

  _PARAMS = ('optimize',)

  def __init__(self, optimize: bool = True, device=None):
    super().__init__(device)
    self.optimize = optimize

  def _posterior_mode(self, k: torch.Tensor):
    """Algorithm 3.1 from f = 0: (log marginal likelihood, pi, W_sr, L,
    a), the temporaries of the last Newton step as sklearn returns them."""
    y = self.y_train_
    f = torch.zeros_like(y)
    lml = -math.inf
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    for _ in range(MAX_NEWTON_STEPS):
      pi = torch.sigmoid(f)
      w = pi * (1 - pi)
      w_sr = torch.sqrt(w)
      w_sr_k = w_sr[:, None] * k
      chol = torch.linalg.cholesky(eye + w_sr_k * w_sr)
      b = w * f + (y - pi)
      a = b - w_sr * torch.cholesky_solve((w_sr_k @ b)[:, None],
                                          chol)[:, 0]
      f = k @ a
      new = float(-0.5 * a.dot(f)
                  - torch.log1p(torch.exp(-(y * 2 - 1) * f)).sum()
                  - torch.log(torch.diagonal(chol)).sum())
      if new - lml < 1e-10:
        break
      lml = new
    return lml, pi, w_sr, chol, a

  def log_marginal_likelihood(self, theta, eval_gradient: bool = False):
    """Algorithm 5.1's value, and its gradient in log theta."""
    if not eval_gradient:
      return self._posterior_mode(kernel(scales_of(theta), self.X_train_))[0]
    k, grads = kernel(scales_of(theta), self.X_train_, eval_gradient=True)
    z, pi, w_sr, chol, a = self._posterior_mode(k)
    r = w_sr[:, None] * torch.cholesky_solve(torch.diag(w_sr), chol)
    c = torch.linalg.solve_triangular(chol, w_sr[:, None] * k, upper=False)
    s_2 = (-0.5 * (torch.diagonal(k) - (c * c).sum(dim=0))
           * (pi * (1 - pi) * (1 - 2 * pi)))
    d_z = []
    for grad in grads:
      s_1 = 0.5 * a.dot(grad @ a) - 0.5 * (r.T * grad).sum()
      b = grad @ (self.y_train_ - pi)
      s_3 = b - k @ (r @ b)
      d_z.append(float(s_1 + s_2.dot(s_3)))
    return z, np.asarray(d_z)

  def fit(self, X, y) -> 'BinaryLaplace':
    from scipy import optimize  # the host optimiser, as sklearn's

    self.X_train_ = _base.as_tensor(X, self.device, _base.F64)
    self.classes_, encoded = _base.encode_labels(y)
    if len(self.classes_) != 2:
      raise ValueError(f'BinaryLaplace needs 2 classes, got '
                       f'{len(self.classes_)}')
    self.y_train_ = torch.as_tensor(encoded, dtype=_base.F64,
                                    device=self.device)
    theta = np.zeros(2)
    if self.optimize:
      def objective(t):
        lml, grad = self.log_marginal_likelihood(t, eval_gradient=True)
        return -lml, -grad

      result = optimize.minimize(objective, theta, method='L-BFGS-B',
                                 jac=True, bounds=[BOUNDS, BOUNDS])
      theta = np.asarray(result.x)
      self.log_marginal_likelihood_value_ = float(-result.fun)
    else:
      self.log_marginal_likelihood_value_ = self.log_marginal_likelihood(
          theta)
    self.scales = scales_of(theta)
    k = kernel(self.scales, self.X_train_)
    _, self.pi_, self.W_sr_, self.L_, a = self._posterior_mode(k)
    self.f_cached = k @ a  # sklearn's last Newton iterate
    return self

  def latent_mean_and_variance(self, X):
    x = _base.as_tensor(X, self.device, _base.F64)
    rows = max(1, _BLOCK_ELEMENTS // max(1, self.X_train_.shape[0]))
    means, variances = [], []
    c = self.scales[0]
    for sl in _base.chunks(x.shape[0], rows):
      k_star = kernel(self.scales, self.X_train_, x[sl])
      means.append(k_star.T @ (self.y_train_ - self.pi_))
      v = torch.linalg.solve_triangular(self.L_, self.W_sr_[:, None] * k_star,
                                        upper=False)
      variances.append(c - (v * v).sum(dim=0))
    return torch.cat(means), torch.cat(variances)

  def positive_probability(self, X) -> torch.Tensor:
    return probit_average(*self.latent_mean_and_variance(X))

  def predict_proba_tensor(self, X) -> torch.Tensor:
    p = self.positive_probability(X)
    return torch.stack([1 - p, p], dim=1)

  def predict(self, X) -> np.ndarray:
    """The sign of the latent mean, as sklearn's."""
    mean, _ = self.latent_mean_and_variance(X)
    return self.classes_[_base.host((mean > 0).to(torch.int64))]


class GaussianProcessClassifier(_base.Classifier):
  """One against the rest over sorted classes; `optimizer=None` keeps
  theta = 0 (c = l = 1)."""

  _PARAMS = ('optimizer',)

  def __init__(self, optimizer: Optional[str] = 'fmin_l_bfgs_b',
               device=None):
    super().__init__(device)
    self.optimizer = optimizer

  def fit(self, X, y) -> 'GaussianProcessClassifier':
    x = _base.as_tensor(X, self.device, _base.F64)
    self.n_features_in_ = x.shape[1]
    self.classes_, encoded = _base.encode_labels(y)
    k = len(self.classes_)
    if k < 2:
      raise ValueError('GaussianProcessClassifier needs two classes')
    columns = [encoded] if k == 2 else [
        (encoded == c).astype(np.int64) for c in range(k)]
    self.estimators_ = [
        BinaryLaplace(self.optimizer is not None, self.device).fit(x, col)
        for col in columns]
    return self

  def predict_proba_tensor(self, X) -> torch.Tensor:
    if len(self.estimators_) == 1:
      return self.estimators_[0].predict_proba_tensor(X)
    probs = torch.stack([e.positive_probability(X)
                         for e in self.estimators_], dim=1)
    return probs / probs.sum(dim=1, keepdim=True)

  def predict(self, X) -> np.ndarray:
    if len(self.estimators_) == 1:
      # The binary classifier learnt the classes' indices.
      mean, _ = self.estimators_[0].latent_mean_and_variance(X)
      return self.classes_[_base.host((mean > 0).to(torch.int64))]
    # sklearn's one-against-the-rest: the largest positive probability,
    # the last class on ties.
    probs = torch.stack([e.positive_probability(X)
                         for e in self.estimators_], dim=1)
    flipped = torch.argmax(probs.flip(1), dim=1)
    return self.classes_[_base.host(len(self.estimators_) - 1 - flipped)]
