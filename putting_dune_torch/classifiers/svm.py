"""`SVC` with an RBF kernel: libsvm's C-SVC, one against one, on the device.

- Training is libsvm's SMO with its second-order working-set selection
  (Fan, Chen and Lin 2005; ties go to the last index, as libsvm's `>=` and
  `<=` give them), its two-variable update and clipping, and its stopping
  rule `m(alpha) - M(alpha) < tol`; no shrinking. The kernel values the
  solver reads are rounded to float32, as libsvm's `Qfloat` cache holds
  them; everything else is float64. All the binary problems of a fit (each
  pair of classes, and with `probability=True` each pair's five
  cross-validation folds) run as one batch: an SMO step is one batched
  step of every problem that has not converged.
- Classes are sorted; pair (i, j), i < j, labels class i +1, and its
  decision value `sum coef K(sv, x) - rho` is positive for class i. The
  fitted state is libsvm's: support vectors grouped by class, `dual_coef`
  (k - 1, n_SV), `rho`, `prob_a` / `prob_b` a pair; `predict` is the
  one-against-one vote (the first class on ties).
- `predict_proba` (probability=True) fits Platt's sigmoid to each pair's
  five-fold cross-validated decision values (the Newton method with
  backtracking of Lin, Lin and Weng) and couples the pairwise
  probabilities by Wu, Lin and Weng's second method. The folds are a
  numpy `RandomState(random_state)` permutation, not libsvm's generator:
  the probabilities are another draw of the same law as sklearn's.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from putting_dune_torch.classifiers import _base
from putting_dune_torch.classifiers import tree as tree_lib

TAU = 1e-12
NR_FOLD = 5
MIN_PROB = 1e-7
# Iterations between host reads of the batch's stopping flags.
_CHECK_EVERY = 32


def rbf(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
  """exp(-gamma |a - b|^2) with the squares summed feature by feature,
  as libsvm's `k_function` (prediction) sums them."""
  return torch.exp(-gamma * _base.squared_distances(a, b))


def rbf_gram(x: torch.Tensor, gamma: float) -> torch.Tensor:
  """The training kernel as libsvm's `kernel_rbf` computes it,
  exp(-gamma (|x_i|^2 + |x_j|^2 - 2 x_i . x_j)), rounded to float32."""
  sq = torch.square(x).sum(dim=1)
  k = torch.exp(-gamma * (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)))
  return k.to(_base.F32)


def smo_batch(gram: torch.Tensor, qd: torch.Tensor, idx: torch.Tensor,
              y: torch.Tensor, valid: torch.Tensor, c: float, eps: float,
              max_iter: int = 10_000_000) -> Tuple[torch.Tensor, ...]:
  """libsvm's `Solver::Solve` for C-SVC on B problems at once.

  gram: (n, n) float32 kernel; qd: (n,) its float64 diagonal; idx (B, L)
  rows of each problem (padded), y (B, L) +-1, valid (B, L). Returns
  (alpha, gradient, rho, objective, iterations), alpha and gradient (B,
  L), the rest (B,).
  """
  b_count, length = idx.shape
  dev = gram.device
  f64 = _base.F64
  rows = torch.arange(b_count, device=dev)
  alpha = torch.zeros((b_count, length), dtype=f64, device=dev)
  grad = torch.where(valid, -torch.ones_like(alpha), torch.zeros_like(alpha))
  qd_b = qd[idx]
  active = torch.ones(b_count, dtype=torch.bool, device=dev)
  neg_inf = torch.tensor(-math.inf, dtype=f64, device=dev)
  pos_inf = torch.tensor(math.inf, dtype=f64, device=dev)
  iterations = torch.zeros(b_count, dtype=torch.int64, device=dev)
  flip = torch.arange(length - 1, -1, -1, device=dev)

  def last_argmax(v):
    return (length - 1) - torch.argmax(v[:, flip], dim=1)

  def q_rows(i):
    """Q_i = y_i y_t K(i, t) of problem b's chosen i, (B, L) float64."""
    krow = gram[idx[rows, i]]
    k = torch.gather(krow, 1, idx).to(f64)
    return y[rows, i][:, None] * y * k

  it = 0
  while it < max_iter:
    for _ in range(_CHECK_EVERY):
      upper = alpha >= c
      lower = alpha <= 0
      pos = y > 0
      in_up = valid & torch.where(pos, ~upper, ~lower)
      in_low = valid & torch.where(pos, ~lower, ~upper)
      up_val = torch.where(in_up, -y * grad, neg_inf)
      i = last_argmax(up_val)
      g_max = up_val[rows, i]
      q_i = q_rows(i)
      yg = y * grad
      g_max2 = torch.where(in_low, yg, neg_inf).max(dim=1).values
      grad_diff = g_max[:, None] + yg
      y_i = y[rows, i]
      quad = qd_b[rows, i][:, None] + qd_b - 2.0 * y_i[:, None] * y * q_i
      quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
      obj = -(grad_diff * grad_diff) / quad
      cand = in_low & (grad_diff > 0)
      obj = torch.where(cand, obj, pos_inf)
      j = last_argmax(-obj)
      has_j = cand.any(dim=1)
      converged = (g_max + g_max2 < eps) | ~has_j | torch.isinf(g_max)
      active = active & ~converged
      q_j = q_rows(j)
      y_j = y[rows, j]
      a_i, a_j = alpha[rows, i], alpha[rows, j]
      g_i, g_j = grad[rows, i], grad[rows, j]
      q_ij = q_i[rows, j]
      qd_i, qd_j = qd_b[rows, i], qd_b[rows, j]
      # y_i != y_j
      quad_a = qd_i + qd_j + 2.0 * q_ij
      quad_a = torch.where(quad_a > 0, quad_a, torch.full_like(quad_a, TAU))
      delta = (-g_i - g_j) / quad_a
      diff = a_i - a_j
      ai_a, aj_a = a_i + delta, a_j + delta
      fix = (diff > 0) & (aj_a < 0)
      ai_a, aj_a = torch.where(fix, diff, ai_a), torch.where(fix, 0.0, aj_a)
      fix = (diff <= 0) & (ai_a < 0)
      ai_a, aj_a = torch.where(fix, 0.0, ai_a), torch.where(fix, -diff, aj_a)
      fix = (diff > 0) & (ai_a > c)
      ai_a, aj_a = torch.where(fix, c, ai_a), torch.where(fix, c - diff, aj_a)
      fix = (diff <= 0) & (aj_a > c)
      ai_a, aj_a = torch.where(fix, c + diff, ai_a), torch.where(fix, c, aj_a)
      # y_i == y_j
      quad_b = qd_i + qd_j - 2.0 * q_ij
      quad_b = torch.where(quad_b > 0, quad_b, torch.full_like(quad_b, TAU))
      delta = (g_i - g_j) / quad_b
      total = a_i + a_j
      ai_b, aj_b = a_i - delta, a_j + delta
      fix = (total > c) & (ai_b > c)
      ai_b, aj_b = torch.where(fix, c, ai_b), torch.where(fix, total - c,
                                                          aj_b)
      fix = (total <= c) & (aj_b < 0)
      ai_b, aj_b = torch.where(fix, total, ai_b), torch.where(fix, 0.0, aj_b)
      fix = (total > c) & (aj_b > c)
      ai_b, aj_b = torch.where(fix, total - c, ai_b), torch.where(fix, c,
                                                                  aj_b)
      fix = (total <= c) & (ai_b < 0)
      ai_b, aj_b = torch.where(fix, 0.0, ai_b), torch.where(fix, total, aj_b)
      same = y_i == y_j
      new_i = torch.where(same, ai_b, ai_a)
      new_j = torch.where(same, aj_b, aj_a)
      new_i = torch.where(active, new_i, a_i)
      new_j = torch.where(active, new_j, a_j)
      d_i, d_j = new_i - a_i, new_j - a_j
      alpha[rows, i] = new_i
      alpha[rows, j] = new_j
      grad = grad + q_i * d_i[:, None] + q_j * d_j[:, None]
      iterations += active.to(torch.int64)
    it += _CHECK_EVERY
    if not bool(active.any()):
      break
  # libsvm's calculate_rho.
  upper = alpha >= c
  lower = alpha <= 0
  pos = y > 0
  yg = y * grad
  free = valid & ~upper & ~lower
  ub_set = valid & ((upper & ~pos) | (lower & pos))
  lb_set = valid & ((upper & pos) | (lower & ~pos))
  ub = torch.where(ub_set, yg, pos_inf).min(dim=1).values
  lb = torch.where(lb_set, yg, neg_inf).max(dim=1).values
  n_free = free.sum(dim=1)
  sum_free = torch.where(free, yg, torch.zeros_like(yg)).sum(dim=1)
  rho = torch.where(n_free > 0, sum_free / n_free.clamp(min=1),
                    (ub + lb) / 2)
  objective = (alpha * (grad - 1.0)).sum(dim=1) / 2
  return alpha, grad, rho, objective, iterations


def sigmoid_train(dec: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[float, float]:
  """libsvm's `sigmoid_train` (Lin, Lin and Weng's Newton method with
  backtracking) on decision values and +-1 labels; returns (A, B) of
  P(+1 | f) = 1 / (1 + exp(A f + B))."""
  dec = dec.to(_base.F64)
  prior1 = float((labels > 0).sum())
  prior0 = dec.shape[0] - prior1
  hi, lo = (prior1 + 1.0) / (prior1 + 2.0), 1.0 / (prior0 + 2.0)
  t = torch.where(labels > 0, hi, lo).to(_base.F64)
  max_iter, min_step, sigma, eps = 100, 1e-10, 1e-12, 1e-5

  def objective(a, b):
    f = dec * a + b
    return float(torch.where(
        f >= 0, t * f + torch.log1p(torch.exp(-f)),
        (t - 1) * f + torch.log1p(torch.exp(f))).sum())

  a, b = 0.0, math.log((prior0 + 1.0) / (prior1 + 1.0))
  fval = objective(a, b)
  for _ in range(max_iter):
    f = dec * a + b
    p = torch.where(f >= 0, torch.exp(-f) / (1.0 + torch.exp(-f)),
                    1.0 / (1.0 + torch.exp(f)))
    q = 1.0 - p
    d2 = p * q
    h11 = sigma + float((dec * dec * d2).sum())
    h22 = sigma + float(d2.sum())
    h21 = float((dec * d2).sum())
    d1 = t - p
    g1, g2 = float((dec * d1).sum()), float(d1.sum())
    if abs(g1) < eps and abs(g2) < eps:
      break
    det = h11 * h22 - h21 * h21
    d_a = -(h22 * g1 - h21 * g2) / det
    d_b = -(-h21 * g1 + h11 * g2) / det
    gd = g1 * d_a + g2 * d_b
    step = 1.0
    while step >= min_step:
      new_a, new_b = a + step * d_a, b + step * d_b
      new_f = objective(new_a, new_b)
      if new_f < fval + 0.0001 * step * gd:
        a, b, fval = new_a, new_b, new_f
        break
      step /= 2.0
    if step < min_step:
      break
  return a, b


def sigmoid_predict(dec: torch.Tensor, a, b) -> torch.Tensor:
  f = dec * a + b
  return torch.where(f >= 0, torch.exp(-f) / (1.0 + torch.exp(-f)),
                     1.0 / (1.0 + torch.exp(f)))


def multiclass_probability(r: torch.Tensor) -> torch.Tensor:
  """Wu, Lin and Weng's method 2 (libsvm's `multiclass_probability`) for
  each row of pairwise probabilities r (m, k, k), r[i, j] = P(i | i or
  j); returns (m, k)."""
  m, k, _ = r.shape
  eye = torch.eye(k, dtype=torch.bool, device=r.device)
  rt = r.transpose(1, 2)
  q = torch.where(eye, torch.zeros_like(r), -rt * r)
  diag = torch.where(eye, torch.zeros_like(r), rt * rt).sum(dim=2)
  q = q + torch.diag_embed(diag)
  p = torch.full((m, k), 1.0 / k, dtype=r.dtype, device=r.device)
  eps = 0.005 / k
  for _ in range(max(100, k)):
    qp = (q @ p[:, :, None])[:, :, 0]
    pqp = (p * qp).sum(dim=1)
    running = (qp - pqp[:, None]).abs().max(dim=1).values >= eps
    if not bool(running.any()):
      break
    for t in range(k):
      diff = (-qp[:, t] + pqp) / q[:, t, t]
      diff = torch.where(running, diff, torch.zeros_like(diff))
      p = p.clone()
      p[:, t] = p[:, t] + diff
      pqp = ((pqp + diff * (diff * q[:, t, t] + 2 * qp[:, t]))
             / (1 + diff) / (1 + diff))
      qp = (qp + diff[:, None] * q[:, t, :]) / (1 + diff[:, None])
      p = p / (1 + diff[:, None])
  return p


class SVC(_base.Classifier):
  """The RBF kernel exp(-gamma |x - x'|^2) with a given gamma (the CLI's
  is 2)."""

  _PARAMS = ('C', 'gamma', 'tol', 'probability', 'random_state')

  def __init__(self, C: float = 1.0, gamma: float = 2.0, tol: float = 1e-3,
               probability: bool = False, random_state=None, device=None):
    super().__init__(device)
    self.C = C
    self.gamma = gamma
    self.tol = tol
    self.probability = probability
    self.random_state = random_state

  def fit(self, X, y) -> 'SVC':
    x = _base.as_tensor(X, self.device, _base.F64)
    self.n_features_in_ = x.shape[1]
    self.classes_, encoded = _base.encode_labels(y)
    k = len(self.classes_)
    if k < 2:
      raise ValueError('SVC needs at least two classes')
    gram = rbf_gram(x, float(self.gamma))
    # libsvm's QD[i] = K(x_i, x_i): |x_i|^2 + |x_i|^2 - 2 x_i.x_i is 0.
    qd = torch.ones(x.shape[0], dtype=_base.F64, device=self.device)
    by_class = [np.flatnonzero(encoded == c) for c in range(k)]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    rng = tree_lib.check_random_state(self.random_state)
    problems: List[Tuple[np.ndarray, np.ndarray]] = []
    folds = []  # (pair, fold members, row of the batch or a constant)
    pair_rows = []
    for i, j in pairs:
      members = np.concatenate([by_class[i], by_class[j]])
      labels = np.concatenate([np.ones(len(by_class[i])),
                               -np.ones(len(by_class[j]))])
      if self.probability:
        perm = rng.permutation(len(members))
        n = len(members)
        for f in range(NR_FOLD):
          begin, end = f * n // NR_FOLD, (f + 1) * n // NR_FOLD
          train = np.concatenate([perm[:begin], perm[end:]])
          n_pos = int((labels[train] > 0).sum())
          n_neg = len(train) - n_pos
          if n_pos and n_neg:
            folds.append(((i, j), perm[begin:end], len(problems), train))
            problems.append((members[train], labels[train]))
          else:
            folds.append(((i, j), perm[begin:end],
                          1.0 if n_pos else (-1.0 if n_neg else 0.0), None))
      pair_rows.append(len(problems))
      problems.append((members, labels))
    alpha, rho = self._solve(gram, qd, problems)
    self.shape_fit_ = tuple(x.shape)
    self.pair_iterations_ = np.asarray(_base.host(self.n_iter_))[pair_rows]
    dec_cv = {pair: torch.zeros(len(by_class[pair[0]]) + len(by_class[pair[1]]),
                                dtype=_base.F64, device=self.device)
              for pair in pairs}
    for pair, fold, row, train in folds:
      members = np.concatenate([by_class[pair[0]], by_class[pair[1]]])
      fold_t = torch.as_tensor(fold, device=self.device)
      if train is None:
        dec_cv[pair][fold_t] = row
        continue
      coef = alpha[row][:len(train)] * torch.as_tensor(
          problems[row][1], dtype=_base.F64, device=self.device)
      kx = gram[torch.as_tensor(members[fold], device=self.device)][
          :, torch.as_tensor(members[train], device=self.device)]
      dec_cv[pair][fold_t] = kx.to(_base.F64) @ coef - rho[row]
    self._assemble(x, by_class, pairs, [alpha[r] for r in pair_rows],
                   rho[pair_rows], [problems[r] for r in pair_rows])
    if self.probability:
      prob_a, prob_b = [], []
      for pair in pairs:
        n_i = len(by_class[pair[0]])
        labels = torch.ones_like(dec_cv[pair])
        labels[n_i:] = -1.0
        a, b = sigmoid_train(dec_cv[pair], labels)
        prob_a.append(a)
        prob_b.append(b)
      self.prob_a = torch.tensor(prob_a, dtype=_base.F64, device=self.device)
      self.prob_b = torch.tensor(prob_b, dtype=_base.F64, device=self.device)
    else:
      self.prob_a = self.prob_b = None
    return self

  def _solve(self, gram, qd, problems):
    """All binary problems as one SMO batch; (alpha rows, rho)."""
    length = max(len(m) for m, _ in problems)
    b_count = len(problems)
    idx = np.zeros((b_count, length), np.int64)
    ys = np.ones((b_count, length))
    valid = np.zeros((b_count, length), bool)
    for b, (members, labels) in enumerate(problems):
      idx[b, :len(members)] = members
      ys[b, :len(members)] = labels
      valid[b, :len(members)] = True
    dev = self.device
    alpha, _, rho, objective, iterations = smo_batch(
        gram, qd, torch.as_tensor(idx, device=dev),
        torch.as_tensor(ys, dtype=_base.F64, device=dev),
        torch.as_tensor(valid, device=dev), float(self.C), float(self.tol))
    self.objective_ = objective
    self.n_iter_ = iterations
    return alpha, rho

  def _assemble(self, x, by_class, pairs, alphas, rho, problems) -> None:
    """libsvm's svm_train tail: the nonzero coefficients of every pair
    model gathered into support vectors grouped by class, `dual_coef`
    (k - 1, n_SV) and `rho`."""
    k = len(by_class)
    nonzero = [np.zeros(len(m), bool) for m in by_class]
    coefs = []
    for (i, j), a, (members, labels) in zip(pairs, alphas, problems):
      coef = (a[:len(members)] * torch.as_tensor(
          labels, dtype=_base.F64, device=self.device)).cpu().numpy()
      n_i = len(by_class[i])
      nonzero[i] |= coef[:n_i] != 0
      nonzero[j] |= coef[n_i:] != 0
      coefs.append(coef)
    counts = [int(nz.sum()) for nz in nonzero]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    dual = np.zeros((k - 1, starts[-1]))
    for (i, j), coef in zip(pairs, coefs):
      n_i = len(by_class[i])
      dual[j - 1, starts[i]:starts[i + 1]] = coef[:n_i][nonzero[i]]
      dual[i, starts[j]:starts[j + 1]] = coef[n_i:][nonzero[j]]
    sv = np.concatenate([m[nz] for m, nz in zip(by_class, nonzero)])
    self.support_ = sv
    self.support_vectors_ = x[torch.as_tensor(sv, device=self.device)]
    self.n_support_ = torch.tensor(counts, device=self.device)
    self.dual_coef = torch.as_tensor(dual, device=self.device)
    self.rho = rho.clone()

  def _pair_matrix(self) -> torch.Tensor:
    """(n_SV, pairs): each pair model's coefficient of every SV."""
    k = len(self.classes_)
    counts = [int(c) for c in self.n_support_]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    cols = []
    for i in range(k):
      for j in range(i + 1, k):
        col = torch.zeros(starts[-1], dtype=_base.F64, device=self.device)
        col[starts[i]:starts[i + 1]] = self.dual_coef[j - 1,
                                                      starts[i]:starts[i + 1]]
        col[starts[j]:starts[j + 1]] = self.dual_coef[i,
                                                      starts[j]:starts[j + 1]]
        cols.append(col)
    return torch.stack(cols, dim=1)

  def pair_decisions(self, X) -> torch.Tensor:
    """libsvm's decision values, (m, pairs), pair (i, j) positive for i."""
    x = _base.as_tensor(X, self.device, _base.F64)
    mat = self._pair_matrix()
    rows = max(1, 2**25 // max(1, self.support_vectors_.shape[0]))
    out = [rbf(x[sl], self.support_vectors_, float(self.gamma)) @ mat
           - self.rho
           for sl in _base.chunks(x.shape[0], rows)]
    return torch.cat(out)

  def decision_function(self, X) -> np.ndarray:
    """sklearn's: for two classes positive for classes_[1]; for more,
    the pairwise (ovo) values."""
    dec = self.pair_decisions(X)
    if len(self.classes_) == 2:
      return _base.host(-dec[:, 0])
    return _base.host(dec)

  def predict(self, X) -> np.ndarray:
    dec = self.pair_decisions(X)
    k = len(self.classes_)
    votes = torch.zeros((dec.shape[0], k), dtype=torch.int64,
                        device=self.device)
    p = 0
    for i in range(k):
      for j in range(i + 1, k):
        win = dec[:, p] > 0
        votes[:, i] += win.to(torch.int64)
        votes[:, j] += (~win).to(torch.int64)
        p += 1
    return self.classes_[_base.host(torch.argmax(votes, dim=1))]

  def predict_proba_tensor(self, X) -> torch.Tensor:
    if self.prob_a is None:
      raise AttributeError('predict_proba needs probability=True')
    dec = self.pair_decisions(X)
    k = len(self.classes_)
    r = torch.zeros((dec.shape[0], k, k), dtype=_base.F64,
                    device=self.device)
    p = 0
    for i in range(k):
      for j in range(i + 1, k):
        prob = sigmoid_predict(dec[:, p], self.prob_a[p], self.prob_b[p])
        prob = prob.clamp(MIN_PROB, 1 - MIN_PROB)
        r[:, i, j] = prob
        r[:, j, i] = 1 - prob
        p += 1
    # sklearn's libsvm couples the pairs for two classes too.
    return multiclass_probability(r)
