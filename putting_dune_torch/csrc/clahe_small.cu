// Whole CLAHE of a small frame in one launch, one block per image.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py `clahe_fused`
// (`_kernel`, with `_nibble_histograms`), the route for tiles of at most
// 512 pixels (128^2 and 64^2 frames at grid 8). For a (B, H, W) f32 batch,
// a grid x grid tile mesh and V = nbins gray levels it computes exactly
// what csrc/clahe_hist_lut.cu followed by csrc/clahe_remap.cu compute:
//   phase 1  bins = clip(int(x * V), 0, V - 1); the g^2 tile histograms;
//   phase 2  per tile: clip at clim = max(clip_limit * tile_pixels, 1),
//            spread the excess uniformly, cumsum, normalize -> mapping;
//   phase 3  per pixel: bilinear blend of the four surrounding tiles'
//            mappings (half-tile-offset blocks, corners clamped to the grid).
//
// What bounds it on an H100: 8 bytes/pixel (frame read once, result
// written once); the second read of the frame in phase 3 hits L1/L2
// (64 KB per image at 128^2). What it keeps out of device memory: the
// histograms and the g^2 V mappings, which live only in shared memory
// (64 KB at grid 8, 256 bins, as dynamic shared memory).
//
// Not the TPU body carried over: that kernel needs pre-binned int32 dual
// blocks, a nibble matmul for the histograms, a triangular matmul for the
// cumsum and 128-lane segment gathers, all workarounds for a chip without
// scatter or gather. Here phase 1 is shared-memory atomics over the frame
// as it lies in memory, phase 2 gives each warp whole tiles and runs
// clahe::tile_mapping (csrc/clahe_lut.cuh, shared with clahe_hist_lut, so
// both routes give identical mappings), and phase 3 gathers from shared
// memory. Simple first: 512 threads, one image per block, so a batch of B
// images fills the card only from B >= 132.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clahe_lut.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int NB>
__global__ void __launch_bounds__(kThreads)
clahe_small_kernel(const float* __restrict__ image, float* __restrict__ out,
                   int* __restrict__ hist_out, int height, int width, int grid,
                   int nbins, float clim) {
  extern __shared__ int smem[];
  const int tiles = grid * grid;
  int* hist = smem;                                  // [tiles][nbins]
  float* maps = reinterpret_cast<float*>(smem);      // same storage, phase 2+

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int th = height / grid, tw = width / grid;
  const int npx = height * width;
  const float* src = image + (size_t)b * npx;
  const float fbins = (float)nbins;

  // ---- phase 1: tile histograms -------------------------------------------
  for (int i = t; i < tiles * nbins; i += kThreads) hist[i] = 0;
  __syncthreads();
  for (int p = t; p < npx; p += kThreads) {
    const int y = p / width, x = p - y * width;
    const int tile = (y / th) * grid + x / tw;
    const int bin = min(max((int)(src[p] * fbins), 0), nbins - 1);
    atomicAdd(&hist[tile * nbins + bin], 1);
  }
  __syncthreads();
  if (hist_out != nullptr) {
    int* dst = hist_out + (size_t)b * tiles * nbins;
    for (int i = t; i < tiles * nbins; i += kThreads) dst[i] = hist[i];
    // Phase 2 writes the mappings over the counts copied here.
    __syncthreads();
  }

  // ---- phase 2: clip, spread, scan, normalize; one warp per tile ----------
  // Each lane reads its own counts into registers and writes its own
  // mapping entries back over them.
  for (int tile = warp; tile < tiles; tile += kWarps) {
    float x[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int v = lane + 32 * j;
      x[j] = v < nbins ? (float)hist[tile * nbins + v] : 0.0f;
    }
    clahe::tile_mapping<NB>(x, nbins, clim, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int v = lane + 32 * j;
      if (v < nbins) maps[tile * nbins + v] = x[j];
    }
  }
  __syncthreads();

  // ---- phase 3: remap every pixel through its four corner mappings --------
  float* dst = out + (size_t)b * npx;
  for (int p = t; p < npx; p += kThreads) {
    const int y = p / width, x = p - y * width;
    const int yy = y + th / 2, xx = x + tw / 2;
    const int bi = yy / th, bj = xx / tw;
    const float fy = ((float)(yy - bi * th) + 0.5f) / (float)th;
    const float fx = ((float)(xx - bj * tw) + 0.5f) / (float)tw;
    const int i0 = min(max(bi - 1, 0), grid - 1), i1 = min(bi, grid - 1);
    const int j0 = min(max(bj - 1, 0), grid - 1), j1 = min(bj, grid - 1);

    const int bin = min(max((int)(src[p] * fbins), 0), nbins - 1);
    const float* lut = maps + bin;
    const float l00 = lut[(i0 * grid + j0) * nbins];
    const float l01 = lut[(i0 * grid + j1) * nbins];
    const float l10 = lut[(i1 * grid + j0) * nbins];
    const float l11 = lut[(i1 * grid + j1) * nbins];
    const float w00 = (1.0f - fy) * (1.0f - fx);
    const float w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx);
    const float w11 = fy * fx;
    dst[p] = l00 * w00 + l01 * w01 + l10 * w10 + l11 * w11;
  }
}

template <int NB>
cudaError_t launch(const float* image, float* out, int* hist, int batch,
                   int height, int width, int grid, int nbins, float clim,
                   int shared, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      clahe_small_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (err != cudaSuccess) return err;
  clahe_small_kernel<NB><<<batch, kThreads, shared, stream>>>(
      image, out, hist, height, width, grid, nbins, clim);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs, in bytes.
extern "C" int clahe_small_shared_bytes(int grid, int nbins) {
  return grid * grid * nbins * (int)sizeof(int);
}

// Returns cudaGetLastError() after the launch (0 on success), or the
// error of raising the kernel's dynamic shared memory limit. `hist` may
// be null.
extern "C" int clahe_small_launch(const float* image, float* out, int* hist,
                                  int batch, int height, int width, int grid,
                                  int nbins, float clim, void* stream) {
  const int shared = clahe_small_shared_bytes(grid, nbins);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nbins <= 128)
    return (int)launch<4>(image, out, hist, batch, height, width, grid, nbins,
                          clim, shared, s);
  if (nbins <= 256)
    return (int)launch<8>(image, out, hist, batch, height, width, grid, nbins,
                          clim, shared, s);
  if (nbins <= 512)
    return (int)launch<16>(image, out, hist, batch, height, width, grid,
                           nbins, clim, shared, s);
  return (int)launch<32>(image, out, hist, batch, height, width, grid, nbins,
                         clim, shared, s);
}
