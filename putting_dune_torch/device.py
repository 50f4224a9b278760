"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
  """Returns the device an entry point runs on: CUDA unless asked otherwise.

  Raises when CUDA is requested (explicitly or by default) but absent, so a
  run meant for the card never drifts onto the CPU unnoticed; pass
  device='cpu' to run on the CPU.
  """
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'CUDA is not available; pass device="cpu" (CLI: --device=cpu) to '
        'run the port on the CPU.'
    )
  return device
