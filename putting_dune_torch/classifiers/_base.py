"""What the classical learners share: input conversion, the classifier
surface (`predict`, `score`, `classes_`) and the fitted state the port's
own files hold.

An estimator names its constructor parameters in `_PARAMS` (JSON values),
its fitted arrays in `_ARRAYS` (device tensors, or host numpy for the
names in `_HOST_ARRAYS`), its lists of device tensors in `_TENSOR_LISTS`,
its fitted scalars in `_SCALARS` and its
sub-estimators in `_CHILDREN` (lists); `state_tree` / `from_state_tree`
walk those, which is all `joblib_io.save` / `joblib_io.load` need.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from putting_dune_torch import device as device_lib

F64 = torch.float64
F32 = torch.float32


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """x as a 2-D-or-less tensor on `device`. Without a dtype, float32 and
  float64 keep theirs and anything else becomes float64, as sklearn's
  `check_array` keeps float32 and float64."""
  t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
  if dtype is None:
    dtype = t.dtype if t.dtype in (F32, F64) else F64
  return t.to(device=device, dtype=dtype)


def host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
      np.asarray(x))


def encode_labels(y) -> tuple[np.ndarray, np.ndarray]:
  """(classes_, y as indices into classes_): np.unique's order."""
  y = host(y).reshape(-1)
  classes, encoded = np.unique(y, return_inverse=True)
  return classes, encoded.astype(np.int64)


class Estimator:
  """Parameters, device and the state walk."""

  _PARAMS: tuple = ()
  _ARRAYS: tuple = ()
  _HOST_ARRAYS: tuple = ('classes_',)
  _TENSOR_LISTS: tuple = ()
  _SCALARS: tuple = ()
  _CHILDREN: tuple = ()

  def __init__(self, device=None):
    self.device = device_lib.resolve_device(device)

  def get_params(self) -> Dict[str, Any]:
    return {name: getattr(self, name) for name in self._PARAMS}

  def __repr__(self) -> str:
    args = ', '.join(f'{k}={v!r}' for k, v in self.get_params().items())
    return f'{type(self).__name__}({args})'

  def state_tree(self, arrays: Dict[str, np.ndarray], prefix: str) -> dict:
    """A JSON-able description of this estimator; its arrays go into
    `arrays` under keys that start with `prefix`."""
    node = {'class': type(self).__name__, 'params': self.get_params(),
            'scalars': {}, 'arrays': [], 'lists': {}, 'children': {}}
    for name in self._SCALARS:
      if hasattr(self, name):
        node['scalars'][name] = _json_scalar(getattr(self, name))
    for name in self._ARRAYS + self._HOST_ARRAYS:
      if getattr(self, name, None) is not None:
        arrays[f'{prefix}{name}'] = host(getattr(self, name))
        node['arrays'].append(name)
    for name in self._TENSOR_LISTS:
      values = getattr(self, name, None)
      if values is not None:
        for i, value in enumerate(values):
          arrays[f'{prefix}{name}.{i}'] = host(value)
        node['lists'][name] = len(values)
    for name in self._CHILDREN:
      node['children'][name] = [
          child.state_tree(arrays, f'{prefix}{name}.{i}.')
          for i, child in enumerate(getattr(self, name, None) or ())]
    return node

  @classmethod
  def from_state_tree(cls, node: dict, arrays, prefix: str, device,
                      registry: Dict[str, type]) -> 'Estimator':
    est = cls.__new__(cls)
    est.device = torch.device(device)
    for name, value in node['params'].items():
      setattr(est, name, tuple(value) if isinstance(value, list) else value)
    for name, value in node['scalars'].items():
      setattr(est, name, value)
    for name in node['arrays']:
      value = np.asarray(arrays[f'{prefix}{name}'])
      setattr(est, name, value if name in cls._HOST_ARRAYS
              else torch.as_tensor(value, device=est.device))
    for name, count in node['lists'].items():
      setattr(est, name, [
          torch.as_tensor(np.asarray(arrays[f'{prefix}{name}.{i}']),
                          device=est.device) for i in range(count)])
    for name, children in node['children'].items():
      setattr(est, name, [
          registry[child['class']].from_state_tree(
              child, arrays, f'{prefix}{name}.{i}.', device, registry)
          for i, child in enumerate(children)])
    est._restored()
    return est

  def _restored(self) -> None:
    """Rebuilds what derives from the restored state (nothing here)."""


def _json_scalar(value):
  if isinstance(value, (np.integer,)):
    return int(value)
  if isinstance(value, (np.floating,)):
    return float(value)
  if isinstance(value, (list, tuple)):
    return [_json_scalar(v) for v in value]
  return value


class Classifier(Estimator):
  """sklearn's classifier surface over `predict_proba`."""

  _estimator_type = 'classifier'

  def predict_proba(self, X) -> np.ndarray:
    return host(self.predict_proba_tensor(X))

  def predict_proba_tensor(self, X) -> torch.Tensor:
    raise NotImplementedError

  def predict(self, X) -> np.ndarray:
    """The class of the largest probability (the first on ties)."""
    return self.classes_[host(torch.argmax(self.predict_proba_tensor(X),
                                           dim=1))]

  def score(self, X, y) -> float:
    """Mean accuracy of `predict(X)` against y (nan for no rows)."""
    y = host(y).reshape(-1)
    if y.size == 0:
      return float('nan')
    return float(np.mean(self.predict(X) == y))


def chunks(n: int, size: int):
  for start in range(0, n, size):
    yield slice(start, min(start + size, n))


def squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """|a_i - b_j|^2 summed feature by feature in order, as scipy's
  `cdist(..., 'sqeuclidean')` and the KD tree sum them (no Gram trick,
  so near ties resolve as they do there)."""
  out = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype,
                    device=a.device)
  for k in range(a.shape[1]):
    out += torch.square(a[:, k, None] - b[None, :, k])
  return out
