// CLAHE bilinear remap through the four surrounding tile LUTs.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py
// `_remap_natural_kernel`, the third pallas_call of
// `clahe_fused_large_natural`. For output pixel (y, x) it takes the
// half-tile-offset dual block that holds (y + th/2, x + tw/2) in the
// edge-padded frame, the in-block weights fy = (row_in_block + 0.5) / th
// and fx likewise, the four corner tiles (i-1, j-1) .. (i, j) with the
// corner indices clamped to the grid, and returns
//   (1-fy)(1-fx) L00[bin] + (1-fy) fx L01[bin] + fy (1-fx) L10[bin]
//   + fy fx L11[bin]
// exactly as putting_dune_tpu/imaging/clahe.py does on the CPU. The LUTs
// stay f32 (the TPU route quantizes its blended LUTs to bf16).
//
// What bounds it on an H100: 8 bytes/pixel of frame traffic (read the
// frame, write the result); the four LUT reads per pixel hit a 64 KB
// per-image table that lives in L1/L2. Design: one thread per output
// pixel, no shared memory, edge clamping done on indices so the padded
// frame is never materialized.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
clahe_remap_kernel(const float* __restrict__ image,
                   const float* __restrict__ mapping, float* __restrict__ out,
                   int batch, int height, int width, int grid) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t npx = (size_t)height * width;
  if (idx >= (size_t)batch * npx) return;
  const int b = (int)(idx / npx);
  const int p = (int)(idx - (size_t)b * npx);
  const int y = p / width, x = p - y * width;
  const int th = height / grid, tw = width / grid;

  const int yy = y + th / 2, xx = x + tw / 2;
  const int bi = yy / th, bj = xx / tw;
  const float fy = ((float)(yy - bi * th) + 0.5f) / (float)th;
  const float fx = ((float)(xx - bj * tw) + 0.5f) / (float)tw;
  const int i0 = min(max(bi - 1, 0), grid - 1), i1 = min(bi, grid - 1);
  const int j0 = min(max(bj - 1, 0), grid - 1), j1 = min(bj, grid - 1);

  const int bin = min(max((int)(image[idx] * 256.0f), 0), kBins - 1);
  const float* lut = mapping + (size_t)b * grid * grid * kBins + bin;
  const float l00 = lut[(i0 * grid + j0) * kBins];
  const float l01 = lut[(i0 * grid + j1) * kBins];
  const float l10 = lut[(i1 * grid + j0) * kBins];
  const float l11 = lut[(i1 * grid + j1) * kBins];
  const float w00 = (1.0f - fy) * (1.0f - fx);
  const float w01 = (1.0f - fy) * fx;
  const float w10 = fy * (1.0f - fx);
  const float w11 = fy * fx;
  out[idx] = l00 * w00 + l01 * w01 + l10 * w10 + l11 * w11;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int clahe_remap_launch(const float* image, const float* mapping,
                                  float* out, int batch, int height, int width,
                                  int grid, void* stream) {
  const size_t total = (size_t)batch * height * width;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  clahe_remap_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      image, mapping, out, batch, height, width, grid);
  return (int)cudaGetLastError();
}
