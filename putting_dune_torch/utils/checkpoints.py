"""Best-of-N training checkpoints: the port's stand-in for orbax's
`CheckpointManager` (the card's machine has no orbax).

Layout: `<directory>/<step>/state.pt` (the model's and the optimizer's
state dicts, torch.save) and `<directory>/<step>/metrics.json` (the step
and the metrics). A save writes into a temporary folder beside the step's
and renames it into place, so a step folder is either whole or absent.

Retention follows orbax 0.11's `BestN` policy with best_mode='max', step
for step: after every save the kept steps are sorted by `best_fn`
(Python's stable `sorted`) and all but the last `max_to_keep` are
deleted, the step just saved included; the best step is the last of that
order. So ties go to the newer step, and the latest step may be gone
(`latest_step` is the newest one kept). `tests/test_torch_checkpoints.py`
holds the kept steps to orbax's on the same metric sequences.

The folders orbax writes cannot be read here: the artifact that crosses
between the two packages is `params.msgpack` (flax bytes), which both
read and write.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Mapping, Optional

import torch

STATE_FILE = 'state.pt'
METRICS_FILE = 'metrics.json'
# Entries that mark a step folder written by orbax.
_ORBAX_MARKERS = ('_CHECKPOINT_METADATA', '_METADATA', 'default')


class CheckpointManager:
  """Saves training state by step and keeps the `max_to_keep` steps whose
  metrics score highest under `best_fn`."""

  def __init__(
      self,
      directory: str,
      *,
      best_fn: Callable[[Mapping[str, float]], float],
      max_to_keep: Optional[int] = None,
  ):
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    self.best_fn = best_fn
    self._metrics: dict[int, dict] = {}
    if os.path.isdir(self.directory):
      for name in os.listdir(self.directory):
        if name.isdigit():
          self._metrics[int(name)] = self._read_metrics(int(name))

  def _path(self, step: int) -> str:
    return os.path.join(self.directory, str(step))

  def _read_metrics(self, step: int) -> dict:
    path = self._path(step)
    if not os.path.exists(os.path.join(path, METRICS_FILE)):
      if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f'{path} is an orbax checkpoint, which putting_dune_torch '
            'cannot read. Carry the weights across as params.msgpack '
            '(save_params_msgpack in the JAX package) instead.')
      raise FileNotFoundError(f'{path} holds no {METRICS_FILE}.')
    with open(os.path.join(path, METRICS_FILE)) as f:
      return json.load(f)['metrics']

  def all_steps(self) -> list[int]:
    return sorted(self._metrics)

  def latest_step(self) -> Optional[int]:
    return max(self._metrics) if self._metrics else None

  def _sorted_by_metric(self) -> list[int]:
    """The kept steps, worst first (orbax's order)."""
    return sorted(self.all_steps(),
                  key=lambda s: self.best_fn(self._metrics[s]))

  def best_step(self) -> Optional[int]:
    """The kept step `best_fn` scores highest (ties to the later step)."""
    ranked = self._sorted_by_metric()
    return ranked[-1] if ranked else None

  def save(self, step: int, state: Mapping[str, Any],
           metrics: Mapping[str, float]) -> None:
    """Writes `state` (a mapping of state dicts and plain values) and the
    metrics as `step`, then deletes what the retention policy drops."""
    os.makedirs(self.directory, exist_ok=True)
    metrics = {k: float(v) for k, v in metrics.items()}
    tmp = tempfile.mkdtemp(prefix=f'.{step}.tmp-', dir=self.directory)
    try:
      torch.save(dict(state), os.path.join(tmp, STATE_FILE))
      with open(os.path.join(tmp, METRICS_FILE), 'w') as f:
        json.dump({'step': step, 'metrics': metrics}, f)
      if os.path.exists(self._path(step)):
        shutil.rmtree(self._path(step))
      os.rename(tmp, self._path(step))
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    self._metrics[step] = metrics
    if self.max_to_keep is not None:
      ranked = self._sorted_by_metric()
      for old in ranked[:max(len(ranked) - self.max_to_keep, 0)]:
        shutil.rmtree(self._path(old))
        del self._metrics[old]

  def restore(self, step: int, map_location=None) -> dict:
    """The state saved as `step`, its tensors on `map_location`."""
    if step not in self._metrics:
      raise FileNotFoundError(f'No step {step} under {self.directory}; '
                              f'kept steps: {self.all_steps()}.')
    return torch.load(os.path.join(self._path(step), STATE_FILE),
                      map_location=map_location, weights_only=True)
