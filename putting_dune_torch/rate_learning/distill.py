"""Ensemble-to-single distillation on synthetic Gaussian data (port of
putting_dune_tpu/rate_learning/distill.py).

The student learns the ensemble's mean per-neighbor rates on contexts
drawn from a Gaussian with the real data's mean and scale. The loss history
stays on the device and is read once, at the end.
"""

from __future__ import annotations

import torch

from putting_dune_torch.rate_learning import losses
from putting_dune_torch.rate_learning import model as model_lib
from putting_dune_torch.utils import training as training_utils


def distill_loss(student, teacher, generator: torch.Generator,
                 batch_size: int, data_mean: torch.Tensor,
                 data_scale: torch.Tensor) -> torch.Tensor:
  """Mean squared distance between the student's and the mean teacher's
  per-neighbor rates on one Gaussian batch (the student in training mode,
  its batch norm updating)."""
  datapoints = torch.randn((batch_size, *data_mean.shape),
                           generator=generator,
                           device=data_mean.device) * data_scale + data_mean
  with torch.no_grad():
    targets = losses.predicted_rates_to_per_neighbor(
        teacher(datapoints, is_training=False)).mean(0)
  pred = losses.predicted_rates_to_per_neighbor(
      student(datapoints, is_training=True))[0]
  return torch.mean(torch.sum(torch.square(pred - targets), dim=-1))


def distill_train_epoch(student, teacher, optimizer,
                        generator: torch.Generator, batches: int,
                        batch_size: int, data_mean: torch.Tensor,
                        data_scale: torch.Tensor) -> torch.Tensor:
  """`batches` AdamW steps; returns the mean loss as a device scalar."""
  total = torch.zeros((), device=data_mean.device)
  for _ in range(batches):
    optimizer.zero_grad(set_to_none=True)
    loss = distill_loss(student, teacher, generator, batch_size, data_mean,
                        data_scale)
    loss.backward()
    optimizer.step()
    total = total + loss.detach()
  return total / batches


def distill_multiple_models_to_single(
    generator: torch.Generator,
    teacher: model_lib.RateMLP,
    batch_size: int,
    epochs: int,
    batches_per_epoch: int,
    data_mean: torch.Tensor,
    data_scale: torch.Tensor,
    learning_rate: float,
    weight_decay: float,
):
  """Distills the ensemble `teacher` into a fresh one-model student of its
  architecture, initialised from `generator`. Returns (student,
  {'distill_loss': (epochs,) numpy})."""
  student = model_lib.RateMLP(
      1, teacher.in_features, teacher.hidden_dimensions, teacher.num_states,
      teacher.batchnorm, device=data_mean.device, generator=generator)
  optimizer = training_utils.adamw(student, learning_rate, weight_decay)
  teacher.eval()
  student.train()
  history = torch.stack([
      distill_train_epoch(student, teacher, optimizer, generator,
                          batches_per_epoch, batch_size, data_mean,
                          data_scale)
      for _ in range(epochs)])
  student.eval()
  return student, {'distill_loss': history.cpu().numpy()}
