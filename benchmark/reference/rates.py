"""The KMC's transition rates under the simple canonical law."""

from __future__ import annotations

import torch

from benchmark.reference import precision as precision_lib

BOND = 1.42


def simple_canonical(neighbor_pos: torch.Tensor, beam_pos: torch.Tensor,
                     precision: str = 'float32') -> torch.Tensor:
  """r_i = 1 / ((4 |beam - n_i| / bond)^2 + 1), (B, 3)."""
  r = lambda t: precision_lib.round_to(t, precision)  # noqa: E731
  dist = torch.linalg.vector_norm(r(beam_pos)[:, None, :] - r(neighbor_pos),
                                  dim=-1)
  return r(1.0 / (torch.square(r(dist / BOND) * 4.0) + 1.0))
