"""Loading a trained atom detector's artifacts.

Port of `load_arch` and the `params.msgpack` branch of `load_params` of
putting_dune_tpu/atom_detection/train.py. The training loop and the orbax
checkpoint branch are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from putting_dune_torch.agents import msgpack_reader


def load_arch(workdir: str) -> Optional[dict]:
  """Reads the arch.json sidecar ({'features', 'image_size'}) if present."""
  path = os.path.join(workdir, 'arch.json')
  if not os.path.exists(path):
    return None
  with open(path) as f:
    return json.load(f)


def load_params(workdir: str) -> dict:
  """The flax parameter tree stored in `workdir`/params.msgpack, as nested
  dicts of numpy arrays (bfloat16 storage widened to float32)."""
  path = os.path.join(workdir, 'params.msgpack')
  if not os.path.exists(path):
    raise FileNotFoundError(
        f'No params.msgpack in {workdir} (orbax checkpoints are not '
        'readable from putting_dune_torch).')
  with open(path, 'rb') as f:
    return msgpack_reader.unpackb(f.read())
