// CLAHE tile histograms + clipped CDF lookup tables, one block per tile.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py
// `clahe_fused_large_natural`'s first two pallas_calls, the histogram
// (`_hist_kernel_nibble_u8`) and the LUT kernel (`_lut_kernel`). Computes,
// for every (image, tile) of a grid x grid mesh:
//   bins     = clip(int(x * 256), 0, 255)
//   hist     = 256-bin histogram of the tile's bins
//   clim     = max(clip_limit * tile_pixels, 1)
//   hist'    = min(hist, clim) + sum(max(hist - clim, 0)) / 256
//   mapping  = cumsum(hist') / sum(hist')
// (the JAX package's one-pass clip law, putting_dune_tpu/imaging/clahe.py,
// not skimage's iterative one).
//
// What bounds it on an H100: reading the frame once (4 bytes/pixel); the
// outputs are 2 KB per tile. The nibble-MXU histogram and the
// triangular-matmul cumsum of the TPU kernels are workarounds for a chip
// without fast scatter; here the histogram is shared-memory atomics and
// the cumsum a 256-wide block scan. Simple first: one block of 256
// threads per tile (6400 blocks at 100 x 512^2, grid 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;

__global__ void __launch_bounds__(kBins)
clahe_hist_lut_kernel(const float* __restrict__ image, int* __restrict__ hist_out,
                      float* __restrict__ mapping, int height, int width,
                      int grid, float clim) {
  __shared__ int hist[kBins];
  __shared__ float scan[2][kBins];
  __shared__ float red[kBins / 32];
  const int t = threadIdx.x;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int th = height / grid, tw = width / grid;
  const int ty = tile / grid, tx = tile - ty * grid;
  const float* src =
      image + (size_t)b * height * width + (size_t)ty * th * width + tx * tw;

  hist[t] = 0;
  __syncthreads();
  const int npx = th * tw;
  for (int p = t; p < npx; p += kBins) {
    const int r = p / tw, c = p - r * tw;
    const int bin = min(max((int)(src[(size_t)r * width + c] * 256.0f), 0),
                        kBins - 1);
    atomicAdd(&hist[bin], 1);
  }
  __syncthreads();

  const size_t out_off = ((size_t)b * grid * grid + tile) * kBins + t;
  const int count = hist[t];
  hist_out[out_off] = count;

  // Clip and redistribute the excess uniformly.
  const float h = (float)count;
  float excess = fmaxf(h - clim, 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    excess += __shfl_xor_sync(0xffffffffu, excess, off);
  if ((t & 31) == 0) red[t >> 5] = excess;
  __syncthreads();
  float total_excess = 0.0f;
#pragma unroll
  for (int w = 0; w < kBins / 32; ++w) total_excess += red[w];
  const float clipped = fminf(h, clim) + total_excess / (float)kBins;

  // Inclusive Hillis-Steele scan over the 256 bins.
  int cur = 0;
  scan[cur][t] = clipped;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {
    const float v = t >= off ? scan[cur][t - off] + scan[cur][t]
                             : scan[cur][t];
    scan[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  mapping[out_off] = scan[cur][t] / scan[cur][kBins - 1];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int clahe_hist_lut_launch(const float* image, int* hist,
                                     float* mapping, int batch, int height,
                                     int width, int grid, float clim,
                                     void* stream) {
  const dim3 blocks(grid * grid, batch);
  clahe_hist_lut_kernel<<<blocks, kBins, 0, (cudaStream_t)stream>>>(
      image, hist, mapping, height, width, grid, clim);
  return (int)cudaGetLastError();
}
