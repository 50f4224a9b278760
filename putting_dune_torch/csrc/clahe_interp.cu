// CLAHE four-corner LUT interpolation over dual blocks.
//
// Replaces: putting_dune_tpu/ops/clahe_pallas.py `clahe_interpolate`
// (kernel body `_interp_kernel`). For every image b, dual block k and
// in-block pixel p:
//   out[b, k, p] = wgt[p, 0] * luts[b, k, bins[b, k, p], 0]
//                + wgt[p, 1] * luts[b, k, bins[b, k, p], 1]
//                + wgt[p, 2] * luts[b, k, bins[b, k, p], 2]
//                + wgt[p, 3] * luts[b, k, bins[b, k, p], 3]
// summed left to right. bins (B, K, P) int32, luts (B, K, V, 4) f32,
// wgt (P, 4) f32, out (B, K, P) f32. The TPU kernel stands a one-hot
// matrix product in for the gather and casts the LUTs to bf16 for its
// matrix unit; here the gather is a gather and the LUTs stay f32.
//
// What bounds it on an H100: bytes. bins, luts and out are each read or
// written once (4 + 4 bytes per pixel and 16 V bytes per dual block); the
// (P, 4) weights are shared by every block and live in L2. Design: one
// block per (b, k) dual block copies its (V, 4) corner LUT into shared
// memory as float4 (4 KB at 256 bins, 16 KB at 1024), then strides over
// the P pixels with coalesced reads of bins and weights and coalesced
// writes; each pixel is one shared-memory float4 read and four
// multiply-adds. V and P are run-time arguments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
clahe_interp_kernel(const int* __restrict__ bins,
                    const float4* __restrict__ luts,
                    const float4* __restrict__ wgt, float* __restrict__ out,
                    int pixels, int nbins) {
  extern __shared__ float4 lut[];
  const size_t block = blockIdx.x;  // b * K + k
  const float4* src = luts + block * nbins;
  for (int v = threadIdx.x; v < nbins; v += kThreads) lut[v] = src[v];
  __syncthreads();

  const int* bin_row = bins + block * pixels;
  float* out_row = out + block * pixels;
  for (int p = threadIdx.x; p < pixels; p += kThreads) {
    const int bin = min(max(bin_row[p], 0), nbins - 1);
    const float4 l = lut[bin];
    const float4 w = wgt[p];
    out_row[p] = w.x * l.x + w.y * l.y + w.z * l.z + w.w * l.w;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int clahe_interp_launch(const int* bins, const float* luts,
                                   const float* wgt, float* out, int blocks,
                                   int pixels, int nbins, void* stream) {
  const size_t shared = (size_t)nbins * sizeof(float4);
  clahe_interp_kernel<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
      bins, (const float4*)luts, (const float4*)wgt, out, pixels, nbins);
  return (int)cudaGetLastError();
}
