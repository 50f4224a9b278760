"""What the three perception trainers share: the train state, optax's
AdamW, the precision context and the epoch loop with best-of-N
checkpoints (the JAX trainers' `train` bodies, one copy here)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Iterator, Mapping, Optional

import torch
from torch import nn

from putting_dune_torch.utils import checkpoints

Metrics = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
  """The model and its optimizer (flax's TrainState: params, tx state)."""

  model: nn.Module
  optimizer: torch.optim.Optimizer

  def state_dict(self) -> dict:
    return {'model': self.model.state_dict(),
            'optimizer': self.optimizer.state_dict()}

  def load_state_dict(self, state: Mapping[str, Any]) -> None:
    self.model.load_state_dict(state['model'])
    self.optimizer.load_state_dict(state['optimizer'])


def adamw(model: nn.Module, learning_rate: float,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
  """optax.adamw(learning_rate, weight_decay=...) as a torch AdamW: b1
  0.9, b2 0.999, eps 1e-8 outside the square root, the decoupled decay on
  every leaf (optax's default decay, 1e-4; torch's is 0.01). On stacked
  (M, ...) parameters each element updates on its own."""
  return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)


@contextlib.contextmanager
def precision(allow_tf32: bool = False) -> Iterator[None]:
  """cuDNN on (its flags default to off inside `cudnn.flags`), with the
  float32 convolutions and matmuls in full float32 unless `allow_tf32`.
  cuDNN picks its algorithms by heuristics (benchmark=False). On an H100
  autotuning the detector's full-f32 step at (32, 256^2, 64..1024) took
  153 s at the first step and then ran it in 159 ms against the
  heuristics' 206 ms (PERF.md §5): it pays only after ~3,300 steps."""
  matmul = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = allow_tf32
  try:
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    allow_tf32=allow_tf32):
      yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = matmul


def apply_gradients(state: TrainState) -> None:
  """The optimizer step on the gradients in `.grad`. A parameter that
  took no part in the loss gets a zero gradient first, so that AdamW
  still decays it, as optax's adamw does (torch skips parameters without
  a gradient)."""
  for p in state.model.parameters():
    if p.grad is None:
      p.grad = torch.zeros_like(p)
  state.optimizer.step()


def check_config(config) -> None:
  """The rules every JAX trainer applies before it starts."""
  if config.steps_per_epoch <= 0 and config.eval_steps <= 0:
    raise ValueError(
        'steps_per_epoch and eval_steps cannot both be 0: every epoch '
        'must produce at least one metric for the best-checkpoint '
        'manager (a checkpoint-flush-only run should set eval_steps>=1).')
  if config.data_source != 'synthetic':
    raise NotImplementedError(
        f'data_source={config.data_source!r}: record-backed datasets wait '
        'for the IO slice (ROADMAP queue 1, IO); use '
        "data_source='synthetic'.")


def manager(workdir: str, best_fn: Callable[[Mapping[str, float]], float],
            max_to_keep: Optional[int] = 3) -> checkpoints.CheckpointManager:
  return checkpoints.CheckpointManager(
      os.path.join(workdir, 'checkpoints'), best_fn=best_fn,
      max_to_keep=max_to_keep)


def mean_metrics(metrics: list[Metrics]) -> dict[str, float]:
  """Per key, the mean over steps, read back in one transfer."""
  keys = list(metrics[0])
  stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                         for m in metrics]).mean(0).tolist()
  return dict(zip(keys, stacked))


def last_metrics(metrics: list[Metrics]) -> dict[str, float]:
  return {k: float(v) for k, v in metrics[-1].items()}


def run_epochs(
    config,
    state: TrainState,
    best_fn: Callable[[Mapping[str, float]], float],
    train_iter,
    eval_iter,
    train_step: Callable[[TrainState, Any], Metrics],
    eval_step: Callable[[TrainState, Any], Metrics],
    summarize: Callable[[list[Metrics], list[Metrics]], dict[str, float]],
    *,
    progress=None,
    stop_fn=None,
) -> TrainState:
  """The JAX trainers' loop: resume from the latest kept checkpoint (its
  epoch + 1), then per epoch `steps_per_epoch` train steps and
  `eval_steps` eval steps, a summary, a checkpoint by epoch and a
  `progress(epoch, summary)` call; `stop_fn()` true before an epoch ends
  the run."""
  ckpt = manager(config.workdir, best_fn)
  start_epoch = 0
  latest = ckpt.latest_step()
  if latest is not None:
    state.load_state_dict(ckpt.restore(
        latest, map_location=next(state.model.parameters()).device))
    start_epoch = latest + 1
  for epoch in range(start_epoch, config.epochs):
    if stop_fn is not None and stop_fn():
      break
    train_metrics = [train_step(state, next(train_iter))
                     for _ in range(config.steps_per_epoch)]
    with torch.no_grad():
      eval_metrics = [eval_step(state, next(eval_iter))
                      for _ in range(config.eval_steps)]
    summary = summarize(train_metrics, eval_metrics)
    ckpt.save(epoch, state.state_dict(), metrics=summary)
    if progress is not None:
      progress(epoch, summary)
  return state


def restore_best(workdir: str, best_fn, map_location=None) -> dict:
  """The model state dict of the best kept checkpoint under `workdir`."""
  ckpt = manager(workdir, best_fn, max_to_keep=None)
  step = ckpt.best_step()
  if step is None:
    raise FileNotFoundError(
        f'No params.msgpack and no checkpoint under {workdir}.')
  return ckpt.restore(step, map_location=map_location)['model']
