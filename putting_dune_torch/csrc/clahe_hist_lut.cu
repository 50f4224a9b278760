// CLAHE tile histograms + clipped CDF lookup tables, one block per tile.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py histogram kernels
// (`_hist_kernel_nibble_u8`, `_hist_kernel_nibble`, `_hist_kernel`) and the
// LUT kernel (`_lut_kernel`) of `clahe_fused_large_natural` and
// `clahe_fused_large`. Computes, for every (image, tile) of a grid x grid
// mesh and V = nbins gray levels (a run-time argument):
//   bins     = clip(int(x * V), 0, V - 1)
//   hist     = V-bin histogram of the tile's bins
//   clim     = max(clip_limit * tile_pixels, 1)
//   hist'    = min(hist, clim) + sum(max(hist - clim, 0)) / V
//   mapping  = cumsum(hist') / sum(hist')
// (the JAX package's one-pass clip law, putting_dune_tpu/imaging/clahe.py,
// not skimage's iterative one).
//
// What bounds it on an H100: reading the frame once (4 bytes/pixel); the
// outputs are 8 V bytes per tile. The TPU package has three histogram
// kernels because of that chip's memory tiling (uint8 vs int32 bins) and
// its matrix-unit nibble trick (exactly 256 bins, 8 tiles a step); none of
// that exists here, so one kernel serves every route: the histogram is
// shared-memory atomics and the cumsum a Hillis-Steele block scan over V
// entries in dynamic shared memory. Simple first: one block of 256 threads
// per tile (6400 blocks at 100 x 512^2, grid 8); each thread owns bins
// t, t + 256, ...
//
// The clip/excess/scan arithmetic (order of every sum) is shared with
// csrc/clahe_small.cu, so the two routes give identical mappings.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
clahe_hist_lut_kernel(const float* __restrict__ image, int* __restrict__ hist_out,
                      float* __restrict__ mapping, int height, int width,
                      int grid, int nbins, float clim) {
  extern __shared__ int smem[];
  int* hist = smem;                                   // [nbins]
  float* scan0 = reinterpret_cast<float*>(smem + nbins);  // [2][nbins]
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int th = height / grid, tw = width / grid;
  const int ty = tile / grid, tx = tile - ty * grid;
  const float* src =
      image + (size_t)b * height * width + (size_t)ty * th * width + tx * tw;
  const float fbins = (float)nbins;

  for (int v = t; v < nbins; v += kThreads) hist[v] = 0;
  __syncthreads();
  const int npx = th * tw;
  for (int p = t; p < npx; p += kThreads) {
    const int r = p / tw, c = p - r * tw;
    const int bin =
        min(max((int)(src[(size_t)r * width + c] * fbins), 0), nbins - 1);
    atomicAdd(&hist[bin], 1);
  }
  __syncthreads();

  const size_t out_off = ((size_t)b * grid * grid + tile) * nbins;

  // Clip and redistribute the excess uniformly.
  float excess = 0.0f;
  for (int v = t; v < nbins; v += kThreads) {
    const int count = hist[v];
    hist_out[out_off + v] = count;
    excess += fmaxf((float)count - clim, 0.0f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    excess += __shfl_xor_sync(0xffffffffu, excess, off);
  if ((t & 31) == 0) red[t >> 5] = excess;
  __syncthreads();
  float total_excess = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total_excess += red[w];
  const float spread = total_excess / fbins;

  // Inclusive Hillis-Steele scan over the nbins entries.
  float* cur = scan0;
  float* nxt = scan0 + nbins;
  for (int v = t; v < nbins; v += kThreads)
    cur[v] = fminf((float)hist[v], clim) + spread;
  __syncthreads();
  for (int off = 1; off < nbins; off <<= 1) {
    for (int v = t; v < nbins; v += kThreads)
      nxt[v] = v >= off ? cur[v - off] + cur[v] : cur[v];
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }
  const float total = cur[nbins - 1];
  for (int v = t; v < nbins; v += kThreads)
    mapping[out_off + v] = cur[v] / total;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int clahe_hist_lut_launch(const float* image, int* hist,
                                     float* mapping, int batch, int height,
                                     int width, int grid, int nbins,
                                     float clim, void* stream) {
  const dim3 blocks(grid * grid, batch);
  const size_t shared = (size_t)nbins * 3 * sizeof(int);
  clahe_hist_lut_kernel<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
      image, hist, mapping, height, width, grid, nbins, clim);
  return (int)cudaGetLastError();
}
