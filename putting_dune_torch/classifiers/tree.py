"""`DecisionTreeClassifier`: gini impurity and sklearn's best splitter.

The tree is built as sklearn 1.9 builds it, so that the same data, sample
weights and seed give the same tree:

- X is cast to float32 (sklearn's `DTYPE`); a threshold is the float64
  midpoint of two consecutive float32 values, values within 1e-7 of each
  other count as equal, and a query goes left when its float32 value is
  at most the threshold;
- samples of weight 0 take no part (a forest's bootstrap draws come in as
  weights, not as repeated rows);
- nodes are split depth first, left child first; at each node the
  features are drawn with sklearn's own generator (`our_rand_r`, seeded by
  one `randint(0, 2**31 - 1)` of the tree's `random_state`), with its
  bookkeeping of constant features, until `max_features` have been drawn
  and one of them was not constant; the first largest proxy improvement
  wins, feature by feature in the order drawn;
- a node's value is its weighted class counts over its weight.

The split search of a node runs on the device (sort, cumulative class
weights, the gini proxy at every position); the draws and the node stack
are host Python, a loop a node.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from putting_dune_torch.classifiers import _base

FEATURE_THRESHOLD = 1e-7
EPSILON = float(np.finfo(np.float64).eps)
RAND_R_MAX = 2**31 - 1
TREE_LEAF = -1
TREE_UNDEFINED = -2
_MASK32 = 0xFFFFFFFF


def check_random_state(seed) -> np.random.RandomState:
  """sklearn's: None is numpy's global RandomState, an int a new one."""
  if seed is None:
    return np.random.mtrand._rand
  if isinstance(seed, np.random.RandomState):
    return seed
  return np.random.RandomState(int(seed))


class RandR:
  """sklearn's `our_rand_r` xorshift and `rand_int` (tree/_utils.pyx)."""

  def __init__(self, seed: int):
    self.state = int(seed) & _MASK32

  def rand_int(self, low: int, high: int) -> int:
    s = self.state or 1  # DEFAULT_SEED
    s ^= (s << 13) & _MASK32
    s ^= s >> 17
    s ^= (s << 5) & _MASK32
    self.state = s
    return low + (s % (RAND_R_MAX + 1)) % (high - low)


def resolve_max_features(max_features, n_features: int) -> int:
  """None (every feature) or 'sqrt', as sklearn counts them."""
  if max_features is None:
    return n_features
  if max_features == 'sqrt':
    return max(1, int(math.sqrt(n_features)))
  raise ValueError(f'max_features={max_features!r}: None or sqrt')


class DecisionTreeClassifier(_base.Classifier):
  _PARAMS = ('max_depth', 'max_features', 'random_state')

  def __init__(self, max_depth: Optional[int] = None, max_features=None,
               random_state=None, device=None):
    super().__init__(device)
    self.max_depth = max_depth
    self.max_features = max_features
    self.random_state = random_state

  @property
  def node_count(self) -> int:
    return int(self.children_left.shape[0])

  def fit(self, X, y) -> 'DecisionTreeClassifier':
    x = _base.as_tensor(X, self.device, _base.F32)
    self.classes_, encoded = _base.encode_labels(y)
    w = torch.ones(x.shape[0], dtype=_base.F64, device=self.device)
    seed = check_random_state(self.random_state).randint(0, RAND_R_MAX)
    self.build(x, torch.as_tensor(encoded, device=self.device), w,
               len(self.classes_), seed)
    return self

  def build(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
            n_classes: int, seed: int) -> None:
    """Grows the tree on float32 x, class indices y and weights w."""
    n_features = x.shape[1]
    max_features = resolve_max_features(self.max_features, n_features)
    max_depth = (np.iinfo(np.int32).max if self.max_depth is None
                 else self.max_depth)
    rng = RandR(seed)
    features = list(range(n_features))
    constant = [0] * n_features
    onehot = torch.nn.functional.one_hot(y, n_classes).to(_base.F64)
    weighted = onehot * w[:, None]
    nodes: List[list] = []  # left, right, feature, threshold, n, wn, imp
    values = []
    samples = torch.nonzero(w != 0).reshape(-1)
    # (samples, depth, parent, is_left, impurity, n_constant_features)
    stack = [(samples, 0, None, False, None, 0)]
    while stack:
      idx, depth, parent, is_left, impurity, n_known = stack.pop()
      counts = weighted[idx].sum(dim=0)
      wn = float(counts.sum())
      if impurity is None:
        impurity = 1.0 - float(torch.square(counts).sum()) / (wn * wn)
      n = int(idx.shape[0])
      is_leaf = depth >= max_depth or n < 2 or impurity <= EPSILON
      split = None
      if not is_leaf:
        split, n_known = self._node_split(
            x, weighted, idx, wn, n_known, features, constant, rng,
            max_features)
        is_leaf = split is None
      node_id = len(nodes)
      nodes.append([TREE_LEAF, TREE_LEAF, TREE_UNDEFINED,
                    float(TREE_UNDEFINED), n, wn, impurity])
      values.append(counts / wn)
      if parent is not None:
        nodes[parent][0 if is_left else 1] = node_id
      if not is_leaf:
        feat, threshold, left, right, imp_left, imp_right = split
        nodes[node_id][2], nodes[node_id][3] = feat, threshold
        stack.append((right, depth + 1, node_id, False, imp_right, n_known))
        stack.append((left, depth + 1, node_id, True, imp_left, n_known))
    table = list(zip(*nodes))
    dev = self.device
    self.children_left = torch.tensor(table[0], dtype=torch.int64, device=dev)
    self.children_right = torch.tensor(table[1], dtype=torch.int64,
                                       device=dev)
    self.feature = torch.tensor(table[2], dtype=torch.int64, device=dev)
    self.threshold = torch.tensor(table[3], dtype=_base.F64, device=dev)
    self.n_node_samples = torch.tensor(table[4], dtype=torch.int64,
                                       device=dev)
    self.weighted_n_node_samples = torch.tensor(table[5], dtype=_base.F64,
                                                device=dev)
    self.impurity = torch.tensor(table[6], dtype=_base.F64, device=dev)
    self.value = torch.stack(values)

  def _node_split(self, x, weighted, idx, wn, n_known, features, constant,
                  rng, max_features):
    """sklearn's `node_split_best`; returns ((feature, threshold, left
    samples, right samples, left impurity, right impurity) or None, the
    constant features known to the children)."""
    f_i = len(features)
    n_visited = n_found = n_drawn = 0
    n_total = n_known
    best, best_proxy = None, -math.inf
    while f_i > n_total and (n_visited < max_features
                             or n_visited <= n_found + n_drawn):
      n_visited += 1
      f_j = rng.rand_int(n_drawn, f_i - n_found)
      if f_j < n_known:
        features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
        n_drawn += 1
        continue
      f_j += n_found
      feat = features[f_j]
      vals, order = torch.sort(x[idx, feat])
      vals = vals.to(_base.F64)
      if float(vals[-1]) <= float(vals[0]) + FEATURE_THRESHOLD:
        features[f_j], features[n_total] = features[n_total], features[f_j]
        n_found += 1
        n_total += 1
        continue
      f_i -= 1
      features[f_i], features[f_j] = features[f_j], features[f_i]
      found = self._best_position(vals, weighted[idx[order]], wn)
      if found is not None and found[0] > best_proxy:
        proxy, p, imp_left, imp_right = found
        best_proxy = proxy
        threshold = float(vals[p - 1]) / 2.0 + float(vals[p]) / 2.0
        best = (feat, threshold, idx[order[:p]], idx[order[p:]],
                imp_left, imp_right)
    features[:n_known] = constant[:n_known]
    constant[n_known:n_known + n_found] = features[n_known:n_known + n_found]
    return best, n_total

  @staticmethod
  def _best_position(vals, weighted, wn):
    """(proxy, p, left impurity, right impurity) of the first best split
    position p (left = the first p sorted samples), or None."""
    valid = vals[1:] > vals[:-1] + FEATURE_THRESHOLD
    if not bool(valid.any()):
      return None
    left = torch.cumsum(weighted, dim=0)[:-1]
    w_left = left.sum(dim=1)
    w_right = wn - w_left
    right = left[-1:] + weighted[-1:] - left  # the node's total less left
    imp_left = 1.0 - torch.square(left).sum(dim=1) / (w_left * w_left)
    imp_right = 1.0 - torch.square(right).sum(dim=1) / (w_right * w_right)
    proxy = -w_right * imp_right - w_left * imp_left
    proxy = torch.where(valid & ~torch.isnan(proxy), proxy,
                        torch.full_like(proxy, -math.inf))
    k = int(torch.argmax(proxy))  # the first largest, as sklearn's '>'
    return float(proxy[k]), k + 1, float(imp_left[k]), float(imp_right[k])

  def apply(self, X) -> torch.Tensor:
    """The leaf each row of X lands in."""
    x = _base.as_tensor(X, self.device, _base.F32)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=self.device)
    rows = torch.arange(x.shape[0], device=self.device)
    for _ in range(self.node_count):
      left = self.children_left[node]
      inner = left != TREE_LEAF
      if not bool(inner.any()):
        break
      feat = self.feature[node].clamp(min=0)
      go_left = x[rows, feat].to(_base.F64) <= self.threshold[node]
      nxt = torch.where(go_left, left, self.children_right[node])
      node = torch.where(inner, nxt, node)
    return node

  def predict_proba_tensor(self, X) -> torch.Tensor:
    proba = self.value[self.apply(X)]
    norm = proba.sum(dim=1, keepdim=True)
    return proba / torch.where(norm == 0, torch.ones_like(norm), norm)
