// One tile's clipped-cdf mapping, computed by one warp in registers.
//
// Shared by csrc/clahe_hist_lut.cu and csrc/clahe_small.cu, so the two CLAHE
// routes give the same mapping bit for bit. For V = nbins gray levels and
// the tile's counts hist[v]:
//   clim     = max(clip_limit * tile_pixels, 1)        (given)
//   excess   = sum_v max(hist[v] - clim, 0)
//   cur[v]   = min(hist[v], clim) + excess / V
//   mapping  = inclusive cumsum(cur) / cumsum(cur)[V - 1]
// Every sum is taken in one fixed order, the order of a 256-thread block:
//   * the excess: thread u of 256 adds bins u, u + 256, ... in turn; the 32
//     threads of each group of 32 are reduced by a xor butterfly (offsets
//     16, 8, 4, 2, 1); the eight group totals are added in sequence;
//   * the cumsum: an inclusive Hillis-Steele scan, round `off` adding
//     cur[v - off] to cur[v] for off = 1, 2, 4, ... < V.
// ops/clahe_fused.py `hist_lut_order_exact` repeats these sums in PyTorch.
//
// Lane `lane` holds bins v = lane + 32 j in x[j], j < NB (NB * 32 >= V).
// Scan rounds with off < 32 take their left operand from lane (lane - off)
// mod 32 by a shuffle (register j, or j - 1 where the lane wraps); rounds
// with off = 32 m take it from register j - m of the same lane. Entries with
// v >= V are never read by a v < V and stay meaningless. No shared memory,
// no barrier.

#pragma once

#include <cuda_runtime.h>

namespace clahe {

// On entry x[j] = (float)hist[lane + 32 j] (anything past V); on return
// x[j] = mapping[lane + 32 j] for lane + 32 j < V.
template <int NB>
__device__ __forceinline__ void tile_mapping(float (&x)[NB], int nbins,
                                             float clim, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  // Excess, in the 256-thread order: group vw of 32 holds registers
  // vw, vw + 8, ...
  float total_excess = 0.0f;
#pragma unroll
  for (int vw = 0; vw < 8; ++vw) {
    float e = 0.0f;
#pragma unroll
    for (int j = vw; j < NB; j += 8)
      if (lane + 32 * j < nbins) e += fmaxf(x[j] - clim, 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e += __shfl_xor_sync(kFull, e, off);
    total_excess += e;
  }
  const float spread = total_excess / (float)nbins;
#pragma unroll
  for (int j = 0; j < NB; ++j) x[j] = fminf(x[j], clim) + spread;

  // Hillis-Steele rounds within a row of 32 bins.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= nbins) break;
    const int src = (lane - off) & 31;
    float s[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j] = __shfl_sync(kFull, x[j], src);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (lane >= off)
        x[j] = s[j] + x[j];
      else if (j > 0)
        x[j] = s[j - 1] + x[j];
    }
  }
  // Rounds across rows: off = 32 m.
#pragma unroll
  for (int m = 1; m < NB; m <<= 1) {
    if (32 * m >= nbins) break;
#pragma unroll
    for (int j = NB - 1; j >= m; --j) x[j] = x[j - m] + x[j];
  }

  const int last = nbins - 1;
  float t = x[0];
#pragma unroll
  for (int j = 1; j < NB; ++j)
    if (j == (last >> 5)) t = x[j];
  const float total = __shfl_sync(kFull, t, last & 31);
#pragma unroll
  for (int j = 0; j < NB; ++j) x[j] = x[j] / total;
}

}  // namespace clahe
