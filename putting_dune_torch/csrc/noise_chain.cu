// Fused seven-stage STEM noise chain, one thread block per frame.
//
// Replaces: putting_dune_tpu/ops/noise_fused_pallas.py `apply_chain_fused`
// (Pallas body `_kernel`, math `chain_from_uniforms`). Stages, in order:
// Poisson shot noise + max-renorm; per-row circular shift by
// Poisson(jitter_rate) clipped to [0, 127]; salt & pepper; gamma
// contrast; additive uniform + renorm; additive exponential + renorm;
// additive Gaussian + clip to [0, 1].
//
// What bounds it on an H100: the frame must be read once and written once
// (8 bytes/pixel, 2 MB per 512^2 frame), but the chain also does ~10
// transcendentals and two Philox4x32-10 blocks per pixel, and three of its
// stages end in a max over the whole frame. Design: one block per frame
// loops over the frame in four passes separated by block-wide max
// reductions. Random numbers are never stored: Philox is counter-based, so
// each pass regenerates the draws it needs from (seed, frame, pixel). The
// Poisson pass writes to a scratch frame because the row roll of the next
// pass reads other threads' pixels; the last three passes work in place
// in the output. Per frame the traffic is image in, scratch out + in, and
// three passes over the output (~24 bytes/pixel), all of it close to L2.
// Simple first: one block per frame leaves SMs idle below 132 frames.
//
// Injected-draws mode (u_pois != nullptr): the eight draw fields are read
// from device arrays instead of Philox, so the kernel can be held
// element-wise against the plain PyTorch twin. Built with --fmad=false so
// every add and multiply rounds as the twin's separate PyTorch ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr float kPoissonSmallLambda = 4.0f;
constexpr int kInversionTerms = 12;
constexpr int kMaxShift = 127;
constexpr float kTwoPi = 6.283185307179586f;

// 1 / (k + 1) rounded once from double, as the JAX and PyTorch versions
// multiply by a Python float.
__constant__ float kInvK[kInversionTerms] = {
    (float)(1.0 / 1), (float)(1.0 / 2), (float)(1.0 / 3), (float)(1.0 / 4),
    (float)(1.0 / 5), (float)(1.0 / 6), (float)(1.0 / 7), (float)(1.0 / 8),
    (float)(1.0 / 9), (float)(1.0 / 10), (float)(1.0 / 11),
    (float)(1.0 / 12)};

struct Draws {
  const float* u_pois;
  const float* z_pois;
  const float* u_sp;
  const float* u_un;
  const float* u_ex;
  const float* z_gauss;
  const float* u_row;
  const float* z_row;
};

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox(uint2 key, uint4 ctr) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      key.x += kW0;
      key.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// Uniform in (0, 1): (2k + 1) * 2^-24 for the top 23 bits k, exact in f32.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return (float)(bits >> 9) * (1.0f / 8388608.0f) + (1.0f / 16777216.0f);
}

__device__ __forceinline__ float box_muller_r(float u1) {
  return sqrtf(-2.0f * logf(fmaxf(u1, 1e-12f)));
}

__device__ __forceinline__ float poisson_from_draws(float u, float z,
                                                    float lam) {
  const float lam_safe = fmaxf(lam, 1e-20f);
  float pmf = expf(-lam_safe);
  float cdf = pmf;
  float count = 0.0f;
#pragma unroll
  for (int k = 0; k < kInversionTerms; ++k) {
    count = count + (u > cdf ? 1.0f : 0.0f);
    pmf = pmf * lam_safe * kInvK[k];
    cdf = cdf + pmf;
  }
  if (lam < kPoissonSmallLambda) return count;
  return fmaxf(floorf(lam + sqrtf(lam_safe) * z + 0.5f), 0.0f);
}

__device__ __forceinline__ float2 box_muller(float u1, float u2) {
  const float r = box_muller_r(u1);
  const float t = kTwoPi * u2;
  return make_float2(r * cosf(t), r * sinf(t));
}

__device__ __forceinline__ uint2 key_of(const long long* seeds, int b) {
  const unsigned long long s = (unsigned long long)seeds[b];
  return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red[] may still be read from the previous call.
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Philox block 0 of a pixel feeds the Box-Muller pair (z_pois = r cos,
// z_gauss = r sin), the Poisson uniform and salt & pepper; block 1 the
// uniform and exponential stages; block 2 of a row index the row shift.
__global__ void __launch_bounds__(kThreads)
noise_chain_kernel(const float* __restrict__ image, float* __restrict__ out,
                   float* __restrict__ scratch, const float* __restrict__ params,
                   const long long* __restrict__ seeds, Draws draws,
                   int height, int width) {
  extern __shared__ int shifts[];  // (height,)
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int npx = height * width;
  const size_t base = (size_t)b * npx;
  const bool injected = draws.u_pois != nullptr;
  const float* prm = params + (size_t)b * 8;
  const float p_pois = prm[0], p_jitter = prm[1], p_sp = prm[2];
  const float p_gamma = prm[3], p_un = prm[4], p_ex = prm[5];
  const float p_gvar = prm[6];
  const uint2 key = injected ? make_uint2(0u, 0u) : key_of(seeds, b);

  // Row shifts ~ Poisson(jitter_rate), clipped to [0, 127].
  for (int y = threadIdx.x; y < height; y += blockDim.x) {
    float u, z;
    if (injected) {
      u = draws.u_row[(size_t)b * height + y];
      z = draws.z_row[(size_t)b * height + y];
    } else {
      const uint4 r = philox(key, make_uint4((uint32_t)y, 2u, (uint32_t)b, 0u));
      u = uniform(r.x);
      z = box_muller(uniform(r.y), uniform(r.z)).x;
    }
    const int s = (int)poisson_from_draws(u, z, p_jitter);
    shifts[y] = min(max(s, 0), kMaxShift);
  }

  // Pass 1: Poisson shot noise into scratch.
  float m = 0.0f;
  for (int i = threadIdx.x; i < npx; i += blockDim.x) {
    float u, z;
    if (injected) {
      u = draws.u_pois[base + i];
      z = draws.z_pois[base + i];
    } else {
      const uint4 r = philox(key, make_uint4((uint32_t)i, 0u, (uint32_t)b, 0u));
      z = box_muller(uniform(r.x), uniform(r.y)).x;
      u = uniform(r.z);
    }
    const float lam = image[base + i] * p_pois;
    const float v = poisson_from_draws(u, z, lam);
    scratch[base + i] = v;
    m = fmaxf(m, v);
  }
  const float d1 = fmaxf(block_max(m, red), 1e-20f);

  // Pass 2: renorm, row roll, salt & pepper, gamma, + uniform.
  const float half_sp = p_sp / 2.0f;
  m = 0.0f;
  for (int i = threadIdx.x; i < npx; i += blockDim.x) {
    const int y = i / width, x = i - y * width;
    int sx = (x - shifts[y]) % width;
    if (sx < 0) sx += width;
    float v = scratch[base + (size_t)y * width + sx] / d1;
    float u_sp, u_un;
    if (injected) {
      u_sp = draws.u_sp[base + i];
      u_un = draws.u_un[base + i];
    } else {
      const uint4 r0 = philox(key, make_uint4((uint32_t)i, 0u, (uint32_t)b, 0u));
      const uint4 r1 = philox(key, make_uint4((uint32_t)i, 1u, (uint32_t)b, 0u));
      u_sp = uniform(r0.w);
      u_un = uniform(r1.x);
    }
    if (u_sp < half_sp) v = 1.0f;
    if (u_sp >= half_sp && u_sp < p_sp) v = 0.0f;
    v = v <= 0.0f ? 0.0f : expf(p_gamma * logf(fmaxf(v, 1e-30f)));
    v = v + u_un * p_un;
    out[base + i] = v;
    m = fmaxf(m, v);
  }
  const float d2 = fmaxf(block_max(m, red), 1e-20f);

  // Pass 3: renorm, + exponential.
  m = 0.0f;
  for (int i = threadIdx.x; i < npx; i += blockDim.x) {
    float u_ex;
    if (injected) {
      u_ex = draws.u_ex[base + i];
    } else {
      const uint4 r1 = philox(key, make_uint4((uint32_t)i, 1u, (uint32_t)b, 0u));
      u_ex = uniform(r1.y);
    }
    const float expo = -logf(fmaxf(u_ex, 1e-12f));
    const float v = out[base + i] / d2 + expo * p_ex;
    out[base + i] = v;
    m = fmaxf(m, v);
  }
  const float d3 = fmaxf(block_max(m, red), 1e-20f);

  // Pass 4: renorm, + Gaussian, clip.
  const float sigma = sqrtf(p_gvar);
  for (int i = threadIdx.x; i < npx; i += blockDim.x) {
    float z;
    if (injected) {
      z = draws.z_gauss[base + i];
    } else {
      const uint4 r = philox(key, make_uint4((uint32_t)i, 0u, (uint32_t)b, 0u));
      z = box_muller(uniform(r.x), uniform(r.y)).y;
    }
    const float v = out[base + i] / d3 + z * sigma;
    out[base + i] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int noise_chain_launch(
    const float* image, float* out, float* scratch, const float* params,
    const long long* seeds, const float* u_pois, const float* z_pois,
    const float* u_sp, const float* u_un, const float* u_ex,
    const float* z_gauss, const float* u_row, const float* z_row, int batch,
    int height, int width, void* stream) {
  const Draws draws{u_pois, z_pois, u_sp, u_un, u_ex, z_gauss, u_row, z_row};
  const size_t smem = (size_t)height * sizeof(int);
  noise_chain_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      image, out, scratch, params, seeds, draws, height, width);
  return (int)cudaGetLastError();
}
