"""What the classical learners share: input conversion and the
classifier surface (`predict`, `score`, `classes_`). An estimator names
its constructor parameters in `_PARAMS`."""

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
  """Parameters and device."""

  _PARAMS: tuple = ()

  def __init__(self, device=None):
    self.device = device_lib.resolve_device(device)

  def get_params(self) -> Dict[str, Any]:
    return {name: getattr(self, name) for name in self._PARAMS}

  def __repr__(self) -> str:
    args = ', '.join(f'{k}={v!r}' for k, v in self.get_params().items())
    return f'{type(self).__name__}({args})'


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
