"""Published peaks of one NVIDIA H100 SXM and the least time of a kernel.

Frozen from chip_smoke.py (lines 301-328, 615-638 and 3869-3880 of the
commit that added this benchmark): the peaks, the operations per pixel of
the noise chain, the CLAHE histogram and remap, `bound` and
`noise_bound`. The numbers stay here whatever the program's copy becomes.
"""

from __future__ import annotations

# NVIDIA's data sheet, SXM part, dense rates, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# No int32 rate is published: 64 int32 lanes beside 128 f32 lanes an SM.
INT32_OPS_PER_S = 33.5e12

PEAK_FLOPS = {'float32': F32_OPS_PER_S, 'tf32': TF32_OPS_PER_S,
              'bfloat16': BF16_OPS_PER_S}

# The least a noise chain with in-kernel draws does a pixel. int32: two
# Philox4x32-10 blocks (10 rounds of 2 multiplies to 4 words and 4 xors)
# and a shift for each of six uniforms. f32: uniforms 18, Box-Muller 9,
# lambda 3, three renorms 9, salt and pepper 5, gamma 6, uniform 2,
# exponential 5, Gaussian 4; the Poisson count 62 below lambda 4, 6 above.
NOISE_INT_OPS_PER_PIXEL = 2 * 10 * 8 + 6
NOISE_F32_OPS_PER_PIXEL = 18 + 9 + 3 + 9 + 5 + 6 + 2 + 5 + 4
NOISE_POISSON_OPS = {'small': 62, 'large': 6}
# clahe_hist_lut: scale, cast, clamp, shared atomic add a pixel.
HIST_OPS_PER_PIXEL = 4
# clahe_remap: bin (3), indices and weights (~12), 4 mul + 3 add.
REMAP_OPS_PER_PIXEL = 22


def bound_s(nbytes: float, f32_ops: float = 0.0, int_ops: float = 0.0
            ) -> float:
  """The least time in seconds: the larger of the bytes' time and the
  operations' time (f32 and int32 leave through the same ports: added)."""
  return max(nbytes / HBM_BYTES_PER_S,
             f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S)


def noise_chain_bound_s(frames: int, height: int, width: int,
                        small_lambda_share: float) -> float:
  """noise_chain on (frames, height, width): read and write 4 bytes a
  pixel, 8 parameters and a seed a frame; `small_lambda_share` of the
  pixels take the inverted Poisson (lambda < 4)."""
  npx = frames * height * width
  f32 = npx * (NOISE_F32_OPS_PER_PIXEL
               + small_lambda_share * NOISE_POISSON_OPS['small']
               + (1.0 - small_lambda_share) * NOISE_POISSON_OPS['large'])
  nbytes = 8.0 * npx + frames * 8 * 4 + frames * 8
  return bound_s(nbytes, f32, NOISE_INT_OPS_PER_PIXEL * npx)


def clahe_hist_lut_bound_s(frames: int, height: int, width: int,
                           grid: int = 8, nbins: int = 256) -> float:
  """clahe_hist_lut on (frames, height, width): reads the frame, writes
  the int32 histograms and the f32 mappings."""
  npx = frames * height * width
  return bound_s(4.0 * npx + frames * grid * grid * nbins * 8,
                 HIST_OPS_PER_PIXEL * npx)


def clahe_remap_bound_s(frames: int, height: int, width: int, grid: int = 8,
                        nbins: int = 256) -> float:
  """clahe_remap on (frames, height, width): reads the frame and the
  mappings, writes the frame."""
  npx = frames * height * width
  return bound_s(8.0 * npx + frames * grid * grid * nbins * 4,
                 REMAP_OPS_PER_PIXEL * npx)
