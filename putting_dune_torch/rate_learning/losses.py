"""Exponential-survival likelihood loss for rate learning (port of
putting_dune_tpu/rate_learning/losses.py).

The model emits [directional logits..., total rate]; the loss combines

  * the total rate's survival likelihood: P(no transition in dt) =
    exp(-rate dt), so -log(1 - exp(-rate dt)) for rows that transitioned
    and rate dt for rows that did not;
  * a cross-entropy over which neighbor was taken, masked to the rows that
    transitioned (next_state in {1..3}; 0 = none).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def loss_from_predictions(
    predicted: torch.Tensor,
    next_state: torch.Tensor,
    elapsed_time: torch.Tensor,
    did_transition: torch.Tensor,
    class_loss_weight: float = 1.0,
    rate_loss_weight: float = 1.0,
):
  """Mean loss over the batch axis (-2) of predictions (..., B, S + 1);
  the targets (..., B) broadcast against them.

  Returns (loss (...,), (per_neighbor_rates, rate_loss, class_loss)), the
  two losses per row.
  """
  did = did_transition.to(predicted.dtype)
  total_rate = predicted[..., -1]
  no_transition_prob = torch.clamp(torch.exp(-total_rate * elapsed_time),
                                   max=1.0 - 1e-6)
  rate_loss = -(did * torch.log1p(-no_transition_prob)
                + (1.0 - did) * (-total_rate * elapsed_time))
  logprobs = F.log_softmax(predicted[..., :-1], dim=-1)
  index = torch.clamp(next_state.long() - 1, min=0)[..., None].expand(
      *predicted.shape[:-1], 1)
  chosen = torch.gather(logprobs, -1, index)[..., 0]
  class_loss = -chosen * did
  losses = class_loss * class_loss_weight + rate_loss * rate_loss_weight
  return (losses.mean(dim=-1),
          (predicted_rates_to_per_neighbor(predicted), rate_loss,
           class_loss))


def batched_loss_fn(
    model,
    next_state: torch.Tensor,
    elapsed_time: torch.Tensor,
    did_transition: torch.Tensor,
    context: torch.Tensor,
    is_training: bool = True,
    class_loss_weight: float = 1.0,
    rate_loss_weight: float = 1.0,
):
  """The loss of each ensemble member on its minibatch.

  context is (M, B, C) (each model its own rows, as in training) or
  (B, C); the targets are (M, B) or (B,). In training the model's batch
  norm updates its running statistics in place. Returns (loss (M,),
  (per_neighbor_rates (M, B, S), rate_loss (M, B), class_loss (M, B))).
  """
  predicted = model(context, is_training=is_training)
  return loss_from_predictions(predicted, next_state, elapsed_time,
                               did_transition, class_loss_weight,
                               rate_loss_weight)


def predicted_rates_to_per_neighbor(predicted: torch.Tensor) -> torch.Tensor:
  """[logits..., total] -> per-neighbor rates (softmax * total)."""
  return torch.softmax(predicted[..., :-1], dim=-1) * predicted[..., -1:]
