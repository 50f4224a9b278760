// CLAHE tile histograms + clipped-cdf lookup tables, one warp per tile.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py histogram kernels
// (`_hist_kernel_nibble_u8`, `_hist_kernel_nibble`, `_hist_kernel`) and the
// LUT kernel (`_lut_kernel`) of `clahe_fused_large_natural` and
// `clahe_fused_large`. Computes, for every (image, tile) of a grid x grid
// mesh and V = nbins gray levels (a run-time argument, 2..1024):
//   bins     = clip(int(x * V), 0, V - 1)
//   hist     = V-bin histogram of the tile's bins
//   clim     = max(clip_limit * tile_pixels, 1)
//   hist'    = min(hist, clim) + sum(max(hist - clim, 0)) / V
//   mapping  = cumsum(hist') / sum(hist')
// (the JAX package's one-pass clip law, putting_dune_tpu/imaging/clahe.py,
// not skimage's iterative one).
//
// What bounds it on an H100: reading the frame once (4 bytes a pixel); the
// outputs are 8 V bytes a tile. The TPU package has three histogram
// kernels because of that chip's memory tiling (uint8 vs int32 bins) and
// its matrix-unit nibble trick; none of that exists here, so one kernel
// serves every route.
//
// Design: one warp per tile, eight warps a block on neighbouring
// tiles of the flattened (image, tile row, tile column) order, so a block
// reads runs of the same frame rows. 6,400 warps at (100, 512, 512) and
// 8,192 at (128, 256, 256): one wave on 132 SMs.
//   * Pixel loop: `float4` loads where the tile width is a multiple of 4
//     and the frame 16-byte aligned (else one float a lane), kUnroll loads
//     in flight a lane; a lane's row and column advance by a fixed step, so
//     the loop has no integer division.
//   * Histogram in the warp's own shared memory, filled with shared-memory
//     atomics: no block barrier at all. On noise-chain frames the kernel is
//     bound by the frame's read, and the remedies for repeated bins
//     (sub-histograms a warp, one add per distinct bin by
//     `__match_any_sync`) were no faster (PERF.md).
//   * LUT: the warp loads the counts into registers and runs
//     clahe::tile_mapping (csrc/clahe_lut.cuh), the same sums in the same
//     order as csrc/clahe_small.cu and as this kernel's earlier block-wide
//     version, so mappings are bit-equal across routes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clahe_lut.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
// A block's shared memory less room for the static arrays.
constexpr int kMaxDynamicShared = 232448 - 1024;

template <int kVec>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void get(T v, float (&o)[1]) { o[0] = v; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void get(T v, float (&o)[4]) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <int kVec, int NB>
__global__ void __launch_bounds__(32 * kWarps)
clahe_hist_lut_kernel(const float* __restrict__ image,
                      int* __restrict__ hist_out, float* __restrict__ mapping,
                      int height, int width, int grid, int nbins, float clim,
                      int num_tiles) {
  extern __shared__ int smem[];
  using VT = typename Vec<kVec>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gt = blockIdx.x * kWarps + warp;  // (image, tile)
  // Warps only ever wait for their own lanes, so a warp past the end may
  // leave at once.
  if (gt >= num_tiles) return;
  int* hist = smem + warp * nbins;
  for (int v = lane; v < nbins; v += 32) hist[v] = 0;
  __syncwarp();

  const int tiles = grid * grid;
  const int b = gt / tiles, tile = gt - b * tiles;
  const int ty = tile / grid, tx = tile - ty * grid;
  const int th = height / grid, tw = width / grid;
  const VT* src = reinterpret_cast<const VT*>(
      image + (size_t)b * height * width + (size_t)ty * th * width + tx * tw);
  const int row = width / kVec;  // vectors in a frame row
  const int twv = tw / kVec;     // vectors in a tile row
  const int nvec = th * twv;
  const float fbins = (float)nbins;

  // Vector q = lane + 32 i of the tile sits at row r, column c; each step
  // of 32 vectors moves (step_r, step_c), wrapping the column once.
  int r = lane / twv, c = lane - r * twv;
  const int step_r = 32 / twv, step_c = 32 - step_r * twv;
  for (int q0 = 0; q0 < nvec; q0 += 32 * kUnroll) {
    VT v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q0 + 32 * u + lane < nvec) v[u] = __ldg(src + (size_t)r * row + c);
      r += step_r;
      c += step_c;
      if (c >= twv) {
        c -= twv;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q0 + 32 * u + lane >= nvec) continue;
      float px[kVec];
      Vec<kVec>::get(v[u], px);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        atomicAdd(&hist[min(max((int)(px[k] * fbins), 0), nbins - 1)], 1);
    }
  }
  __syncwarp();

  const size_t out_off = (size_t)gt * nbins;
  float x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int v = lane + 32 * j;
    int count = 0;
    if (v < nbins) {
      count = hist[v];
      hist_out[out_off + v] = count;
    }
    x[j] = (float)count;
  }
  clahe::tile_mapping<NB>(x, nbins, clim, lane);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int v = lane + 32 * j;
    if (v < nbins) mapping[out_off + v] = x[j];
  }
}

template <int kVec, int NB>
cudaError_t launch(const float* image, int* hist, float* mapping, int batch,
                   int height, int width, int grid, int nbins, float clim,
                   cudaStream_t stream) {
  auto kernel = clahe_hist_lut_kernel<kVec, NB>;
  const size_t shared = (size_t)kWarps * nbins * sizeof(int);
  if (shared > (size_t)kMaxDynamicShared) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  const int num_tiles = batch * grid * grid;
  const int blocks = (num_tiles + kWarps - 1) / kWarps;
  kernel<<<blocks, 32 * kWarps, shared, stream>>>(
      image, hist, mapping, height, width, grid, nbins, clim, num_tiles);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t launch_nb(const float* image, int* hist, float* mapping,
                      int batch, int height, int width, int grid, int nbins,
                      float clim, cudaStream_t s) {
  if (nbins <= 128)
    return launch<kVec, 4>(image, hist, mapping, batch, height, width, grid,
                           nbins, clim, s);
  if (nbins <= 256)
    return launch<kVec, 8>(image, hist, mapping, batch, height, width, grid,
                           nbins, clim, s);
  if (nbins <= 512)
    return launch<kVec, 16>(image, hist, mapping, batch, height, width, grid,
                            nbins, clim, s);
  return launch<kVec, 32>(image, hist, mapping, batch, height, width, grid,
                          nbins, clim, s);
}

}  // namespace

// Returns the launch's cudaError (0 on success).
extern "C" int clahe_hist_lut_launch(const float* image, int* hist,
                                     float* mapping, int batch, int height,
                                     int width, int grid, int nbins,
                                     float clim, void* stream) {
  if (batch <= 0 || grid <= 0 || nbins < 2 || nbins > 1024 ||
      height % grid || width % grid)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (width / grid) % 4 == 0 && ((uintptr_t)image & 15u) == 0;
  return (int)(vec ? launch_nb<4>(image, hist, mapping, batch, height, width,
                                  grid, nbins, clim, s)
                   : launch_nb<1>(image, hist, mapping, batch, height, width,
                                  grid, nbins, clim, s));
}
