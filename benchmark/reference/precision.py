"""The precision a reference computation runs in.

A configuration states each stage's precision: 'float32' for a stage
with matmuls or convolutions in full float32 (TF32 off), 'tf32' for one
whose convolutions run in TF32, 'float32_elementwise' for one of float32
elementwise arithmetic and reductions alone, where TF32 does not apply.
The reference computes in full float32. The control of the correctness
check computes each stage one step below (`LOWER`): 'tf32' runs matmuls
and convolutions on the tensor cores in TF32 and rounds the stage's
elementwise inputs to TF32's 10-bit mantissa; 'bfloat16' runs a network
in bfloat16 and rounds elementwise intermediates to bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

# The precision one step below each stated precision.
LOWER = {'float32': 'tf32', 'tf32': 'bfloat16',
         'float32_elementwise': 'bfloat16'}


@contextlib.contextmanager
def matmul_mode(precision: str):
  """Matmuls and cuDNN convolutions in TF32 only for 'tf32'."""
  tf32 = precision == 'tf32'
  old = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  try:
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=tf32):
      yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = old


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
  """x rounded (to nearest) to `precision`'s mantissa, kept in float32."""
  if precision == 'float32' or not x.is_floating_point():
    return x
  if precision == 'bfloat16':
    return x.to(torch.bfloat16).to(torch.float32)
  bits = x.contiguous().view(torch.int32)
  rounded = (bits + 0x1000) & ~0x1FFF
  return rounded.view(torch.float32)
