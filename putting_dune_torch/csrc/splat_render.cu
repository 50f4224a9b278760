// Fused Gaussian splat: clean STEM frames from atom bins in one call.
//
// Replaces: putting_dune_tpu/ops/splat_pallas.py `splat_render` (kernel
// body `_kernel`). Per image b, with integer bins bx, by in [0, S), the
// flipped row bin byf = S-1-by, weights w (0 for masked atoms) and the two
// truncated Gaussian profiles of length 2S
//   prof[j] = exp(-0.5 ((j - S) / sigma)^2)  if |j - S| <= floor(4 sigma + 0.5)
//           = 0                               otherwise,
// it computes
//   image[y, x] = sum_k w_k * profy[y - byf_k + S] * profx[x - bx_k + S]
// and returns image / max(max(image), 1e-20). The factors stay f32 and the
// sum is taken in f32 in atom order (the TPU kernel casts the factors to
// bf16 for its matrix unit; that trade is not carried over).
//
// What bounds it on an H100: the S*S f32 output written once (bins and
// weights are negligible). A dense contraction would do 2*K*S*S operations
// per image, but a profile is zero beyond its radius (~19 pixels at
// sigma 4.8), so an atom touches ~39^2 pixels: the kernel does the sparse
// work. Design: one block per (image, 32x8 output tile). The block builds
// both profiles in shared memory, then walks the K atoms in chunks of one
// per thread: each thread tests its atom against the tile grown by the
// radius, the hits are compacted into shared memory in atom order (warp
// ballot + a prefix over the warps, so the order of the sum is fixed), and
// every thread adds the hits to its pixel. Nothing per (atom, pixel) ever
// reaches device memory. The per-image peak needs every tile of the
// image: each block folds its maximum into peak[b] with an atomicMax on
// the bit pattern (the sums are non-negative, so the integer order is the
// float order), and a second pass divides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
splat_accumulate_kernel(const float* __restrict__ bx,
                        const float* __restrict__ by,
                        const float* __restrict__ weights,
                        const float* __restrict__ sigma_x,
                        const float* __restrict__ sigma_y,
                        float* __restrict__ out, int* __restrict__ peak_bits,
                        int num_atoms, int size) {
  extern __shared__ float smem[];
  float* profx = smem;              // 2S
  float* profy = smem + 2 * size;   // 2S
  __shared__ int hit_x[kThreads];
  __shared__ int hit_y[kThreads];
  __shared__ float hit_w[kThreads];
  __shared__ int warp_count[kWarps];
  __shared__ float warp_max[kWarps];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x * kTileW + (tid % kTileW);
  const int y = blockIdx.y * kTileH + (tid / kTileW);

  const float sx = sigma_x[b], sy = sigma_y[b];
  const float rx = floorf(4.0f * sx + 0.5f);
  const float ry = floorf(4.0f * sy + 0.5f);
  for (int j = tid; j < 2 * size; j += kThreads) {
    const float d = (float)(j - size);
    const float qx = d / sx, qy = d / sy;
    profx[j] = fabsf(d) <= rx ? expf(-0.5f * (qx * qx)) : 0.0f;
    profy[j] = fabsf(d) <= ry ? expf(-0.5f * (qy * qy)) : 0.0f;
  }

  // The tile grown by the radius, in bin coordinates.
  const int irx = (int)rx, iry = (int)ry;
  const int x_lo = blockIdx.x * kTileW - irx;
  const int x_hi = blockIdx.x * kTileW + kTileW - 1 + irx;
  const int y_lo = blockIdx.y * kTileH - iry;
  const int y_hi = blockIdx.y * kTileH + kTileH - 1 + iry;

  const size_t atom_base = (size_t)b * num_atoms;
  float acc = 0.0f;
  for (int k0 = 0; k0 < num_atoms; k0 += kThreads) {
    const int k = k0 + tid;
    int ax = 0, ay = 0;
    float aw = 0.0f;
    bool hit = false;
    if (k < num_atoms) {
      aw = weights[atom_base + k];
      // Clamped as the twin clamps: the profile reads below stay in [0, 2S).
      ax = min(max((int)bx[atom_base + k], 0), size - 1);
      ay = (size - 1) - min(max((int)by[atom_base + k], 0), size - 1);
      hit = aw != 0.0f && ax >= x_lo && ax <= x_hi && ay >= y_lo && ay <= y_hi;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();  // also orders the profile writes before the first use
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      if (w < warp) offset += c;
      total += c;
    }
    if (hit) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      hit_x[slot] = ax;
      hit_y[slot] = ay;
      hit_w[slot] = aw;
    }
    __syncthreads();
    if (x < size && y < size) {
      for (int i = 0; i < total; ++i) {
        const float fy = profy[y - hit_y[i] + size];
        const float fx = profx[x - hit_x[i] + size];
        acc += (hit_w[i] * fy) * fx;
      }
    }
    __syncthreads();
  }

  if (x < size && y < size) {
    out[((size_t)b * size + y) * size + x] = acc;
  }
  float m = (x < size && y < size) ? acc : 0.0f;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  }
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float bm = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, warp_max[w]);
    atomicMax(peak_bits + b, __float_as_int(bm));
  }
}

__global__ void __launch_bounds__(kThreads)
splat_normalize_kernel(float* __restrict__ out,
                       const int* __restrict__ peak_bits, int batch,
                       size_t pixels) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)batch * pixels) return;
  const int b = (int)(idx / pixels);
  const float peak = fmaxf(__int_as_float(peak_bits[b]), 1e-20f);
  out[idx] = out[idx] / peak;
}

}  // namespace

// `peak_bits` is a zeroed (B,) int32 scratch buffer. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int splat_render_launch(const float* bx, const float* by,
                                   const float* weights, const float* sigma_x,
                                   const float* sigma_y, float* out,
                                   int* peak_bits, int batch, int num_atoms,
                                   int size, void* stream) {
  const dim3 grid((size + kTileW - 1) / kTileW, (size + kTileH - 1) / kTileH,
                  batch);
  const size_t shared = (size_t)4 * size * sizeof(float);
  splat_accumulate_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      bx, by, weights, sigma_x, sigma_y, out, peak_bits, num_atoms, size);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const size_t pixels = (size_t)size * size;
  const size_t total = (size_t)batch * pixels;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  splat_normalize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, peak_bits, batch, pixels);
  return (int)cudaGetLastError();
}
