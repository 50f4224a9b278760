// Fused seven-stage STEM noise chain, one thread block cluster per frame.
//
// Replaces: putting_dune_tpu/ops/noise_fused_pallas.py `apply_chain_fused`
// (Pallas body `_kernel`, math `chain_from_uniforms`). Stages, in order:
// Poisson shot noise + max-renorm; per-row circular shift by
// Poisson(jitter_rate) clipped to [0, 127]; salt & pepper; gamma
// contrast; additive uniform + renorm; additive exponential + renorm;
// additive Gaussian + clip to [0, 1].
//
// What bounds it on an H100: instructions, not bytes. The frame is read
// once and written once (8 bytes/pixel), but each pixel needs two
// Philox4x32-10 blocks (integer multiplies and xors), a Box-Muller pair,
// a 12-term Poisson inversion, three logarithms, two exponentials and three
// true divisions: several hundred executed instructions, which the card
// cannot execute in the time the bytes take. The design therefore spends
// each instruction once and keeps every SM busy:
//
//   * A frame is split by rows over the blocks of one thread block cluster
//     (up to 16, the non-portable size; 8 blocks of 8,192 pixels at 256^2,
//     16 of 16,384 at 512^2). The three frame-wide maxima, the
//     only true barriers of the chain, cross the blocks through
//     distributed shared memory: each block publishes its partial maximum,
//     `cluster.sync()`, and every block reads all partials. A maximum is
//     exact in any order, so the partition changes no bit.
//   * Each Philox block and each Box-Muller pair is generated once. What a
//     later stage needs is carried beside the running value: the Gaussian
//     draw (the sine branch of the pair whose cosine feeds the Poisson
//     stage), the salt & pepper uniform, and then the exponential draw in
//     the slot the salt & pepper uniform has left.
//   * The block's slice of the frame lives on chip: running value and the
//     two carried fields are 12 bytes/pixel of dynamic shared memory (192 KB
//     for the 32 rows of a 512^2 frame), so between the read of the clean
//     frame and the write of the result no stage touches device memory.
//     A frame too large for that (more than ~19,000 pixels per block)
//     keeps the same three fields in a device scratch buffer instead; the
//     kernel is the same template with other pointers.
//   * The row roll is done on the store side: the Poisson stage writes its
//     value to the rolled position of its own row, which lies in the same
//     block, so every later stage is pixel-local and in place.
//   * The image, the injected draws, the carried fields and the output move
//     as 16-byte vectors, four pixels a thread, whenever the width is a
//     multiple of four and the pointers are aligned; any other shape takes
//     the one-pixel instantiation of the same kernel.
//
// A cooperative launch with `grid.sync()` would need every block resident
// at once and its maxima in device memory; a chain of kernels would put
// ~40 bytes/pixel of carried fields through device memory, as long as the
// arithmetic takes. The cluster keeps both on chip. Tensor cores, TMA and
// `wgmma` have no work here: there is no matrix product and no tile that
// is reused.
//
// Philox mode is a pure function of (seed, frame, pixel): counters
// (pixel, 0 | 1, frame, 0) and (row, 2, frame, 0), whatever the partition.
// Injected-draws mode (u_pois != nullptr) reads the eight draw fields from
// device arrays instead, so the kernel can be held element-wise against the
// plain PyTorch twin. Built with --fmad=false so every add and multiply
// rounds as the twin's separate PyTorch ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Registers are capped for 1,024 threads a block (64 a thread); the launch
// picks 256, 512 or 1,024 so that an SM holds 32 warps whatever the shared
// memory of a block lets it hold.
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
// A frame is split until a block has at most this many pixels (96 KB of
// fields, two blocks an SM), and further, down to kMinBlockPixels, while
// the batch gives the card fewer than kWantBlocks blocks.
constexpr int kTargetBlockPixels = 8192;
constexpr int kMinBlockPixels = 1024;
constexpr int kWantBlocks = 2 * 132;
constexpr int kSharedPerSm = 232448;
// Dynamic shared memory a block may ask for, less the static arrays below.
constexpr int kMaxDynamicShared = 232448 - 1024;
constexpr int kFields = 3;  // running value, Gaussian draw, S&P / exponential.
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

// 12-term CDF inversion below lambda = 4, rounded normal above.
__device__ __forceinline__ float poisson_from_draws(float u, float z,
                                                    float lam) {
  const float lam_safe = fmaxf(lam, 1e-20f);
  if (lam < kPoissonSmallLambda) {
    float pmf = expf(-lam_safe);
    float cdf = pmf;
    float count = 0.0f;
#pragma unroll
    for (int k = 0; k < kInversionTerms; ++k) {
      count = count + (u > cdf ? 1.0f : 0.0f);
      pmf = pmf * lam_safe * kInvK[k];
      cdf = cdf + pmf;
    }
    return count;
  }
  return fmaxf(floorf(lam + sqrtf(lam_safe) * z + 0.5f), 0.0f);
}

__device__ __forceinline__ uint2 key_of(const long long* seeds, int b) {
  const unsigned long long s = (unsigned long long)seeds[b];
  return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = p[k];
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) p[k] = v[k];
  }
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

// Maximum over the whole frame of the non-negative per-thread values: the
// block's maximum goes to `slot` in its own shared memory, and after the
// cluster barrier every thread reads the slots of all blocks of the frame.
__device__ __forceinline__ float frame_max(float v, float* red, float* slot,
                                           cg::cluster_group& cluster) {
  v = block_max(v, red);
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  const unsigned blocks = cluster.num_blocks();
  float m = 0.0f;
  for (unsigned r = 0; r < blocks; ++r)
    m = fmaxf(m, *cluster.map_shared_rank(slot, r));
  return m;
}

// Philox block 0 of a pixel feeds the Box-Muller pair (z_pois = r cos,
// z_gauss = r sin), the Poisson uniform and salt & pepper; block 1 the
// uniform and exponential stages; block 2 of a row index the row shift.
//
// Block `rank` of a frame's cluster owns rows [rank * rows_per_block, ...)
// of that frame: `cap` = rows_per_block * width pixels at most. `fields` is
// the dynamic shared memory when kOnChip, else a device buffer of
// kFields x (frames, height, width).
template <bool kInjected, int kVec, bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads)
noise_chain_kernel(const float* __restrict__ image, float* __restrict__ out,
                   float* __restrict__ scratch,
                   const float* __restrict__ params,
                   const long long* __restrict__ seeds, Draws draws,
                   int height, int width, int rows_per_block) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[32];
  __shared__ float part[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int row0 = min(rank * rows_per_block, height);
  const int row1 = min(row0 + rows_per_block, height);
  const int n = (row1 - row0) * width;
  const int pix0 = row0 * width;  // first pixel of the block in its frame.
  const size_t npx = (size_t)height * width;
  const size_t base = (size_t)b * npx + pix0;

  float *val, *gauss, *carry;
  int* shifts;
  if (kOnChip) {
    const int cap = rows_per_block * width;
    val = dyn;
    gauss = val + cap;
    carry = gauss + cap;
    shifts = reinterpret_cast<int*>(carry + cap);
  } else {
    const size_t field = (size_t)(gridDim.x / csize) * npx;
    val = scratch + base;
    gauss = val + field;
    carry = gauss + field;
    shifts = reinterpret_cast<int*>(dyn);
  }

  const float* prm = params + (size_t)b * 8;
  const float p_pois = prm[0], p_jitter = prm[1], p_sp = prm[2];
  const float p_gamma = prm[3], p_un = prm[4], p_ex = prm[5];
  const float p_gvar = prm[6];
  const uint2 key = kInjected ? make_uint2(0u, 0u) : key_of(seeds, b);

  // Row shifts ~ Poisson(jitter_rate), clipped to [0, 127], then reduced
  // modulo the width so that one conditional subtraction wraps a column.
  for (int r = threadIdx.x; r < row1 - row0; r += blockDim.x) {
    const int y = row0 + r;
    float u, z;
    if (kInjected) {
      u = draws.u_row[(size_t)b * height + y];
      z = draws.z_row[(size_t)b * height + y];
    } else {
      const uint4 q = philox(key, make_uint4((uint32_t)y, 2u, (uint32_t)b, 0u));
      u = uniform(q.x);
      z = box_muller_r(uniform(q.y)) * cosf(kTwoPi * uniform(q.z));
    }
    const int s = (int)poisson_from_draws(u, z, p_jitter);
    shifts[r] = min(max(s, 0), kMaxShift) % width;
  }
  __syncthreads();

  const int step = blockDim.x * kVec;
  const int first = threadIdx.x * kVec;

  // Stage 1: Poisson shot noise, stored at the rolled column of its row.
  const int step_r = step / width, step_x = step - step_r * width;
  int r = first / width, x = first - r * width;
  float m = 0.0f;
  for (int i = first; i < n; i += step) {
    float img[kVec], u[kVec], z[kVec], zg[kVec], usp[kVec];
    load_vec<kVec>(image + base + i, img);
    if (kInjected) {
      load_vec<kVec>(draws.u_pois + base + i, u);
      load_vec<kVec>(draws.z_pois + base + i, z);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint4 q = philox(
            key, make_uint4((uint32_t)(pix0 + i + k), 0u, (uint32_t)b, 0u));
        const float rad = box_muller_r(uniform(q.x));
        float sn, cs;
        sincosf(kTwoPi * uniform(q.y), &sn, &cs);
        z[k] = rad * cs;
        zg[k] = rad * sn;
        u[k] = uniform(q.z);
        usp[k] = uniform(q.w);
      }
      store_vec<kVec>(gauss + i, zg);
      store_vec<kVec>(carry + i, usp);
    }
    const int s = shifts[r];
    float* row = val + r * width;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float v = poisson_from_draws(u[k], z[k], img[k] * p_pois);
      m = fmaxf(m, v);
      int sx = x + k + s;
      if (sx >= width) sx -= width;
      row[sx] = v;
    }
    r += step_r;
    x += step_x;
    if (x >= width) {
      x -= width;
      r += 1;
    }
  }
  m = frame_max(m, red, &part[0], cluster);
  // The barrier inside frame_max also orders the rolled stores before
  // the reads below.
  const float d1 = fmaxf(m, 1e-20f);

  // Stage 2: renorm, salt & pepper, gamma, + uniform.
  const float half_sp = p_sp / 2.0f;
  m = 0.0f;
  for (int i = first; i < n; i += step) {
    float v[kVec], usp[kVec], uun[kVec], expo[kVec];
    load_vec<kVec>(val + i, v);
    if (kInjected) {
      load_vec<kVec>(draws.u_sp + base + i, usp);
      load_vec<kVec>(draws.u_un + base + i, uun);
    } else {
      load_vec<kVec>(carry + i, usp);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint4 q = philox(
            key, make_uint4((uint32_t)(pix0 + i + k), 1u, (uint32_t)b, 0u));
        uun[k] = uniform(q.x);
        expo[k] = -logf(fmaxf(uniform(q.y), 1e-12f));
      }
      store_vec<kVec>(carry + i, expo);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float w = v[k] / d1;
      if (usp[k] < half_sp) w = 1.0f;
      if (usp[k] >= half_sp && usp[k] < p_sp) w = 0.0f;
      w = w <= 0.0f ? 0.0f : expf(p_gamma * logf(fmaxf(w, 1e-30f)));
      w = w + uun[k] * p_un;
      m = fmaxf(m, w);
      v[k] = w;
    }
    store_vec<kVec>(val + i, v);
  }
  const float d2 = fmaxf(frame_max(m, red, &part[1], cluster), 1e-20f);

  // Stage 3: renorm, + exponential.
  m = 0.0f;
  for (int i = first; i < n; i += step) {
    float v[kVec], expo[kVec];
    load_vec<kVec>(val + i, v);
    if (kInjected) {
      load_vec<kVec>(draws.u_ex + base + i, expo);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        expo[k] = -logf(fmaxf(expo[k], 1e-12f));
    } else {
      load_vec<kVec>(carry + i, expo);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = v[k] / d2 + expo[k] * p_ex;
      m = fmaxf(m, v[k]);
    }
    store_vec<kVec>(val + i, v);
  }
  const float d3 = fmaxf(frame_max(m, red, &part[2], cluster), 1e-20f);

  // Stage 4: renorm, + Gaussian, clip.
  const float sigma = sqrtf(p_gvar);
  for (int i = first; i < n; i += step) {
    float v[kVec], z[kVec];
    load_vec<kVec>(val + i, v);
    load_vec<kVec>((kInjected ? draws.z_gauss + base : gauss) + i, z);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = fminf(fmaxf(v[k] / d3 + z[k] * sigma, 0.0f), 1.0f);
    store_vec<kVec>(out + base + i, v);
  }
  // No block may leave while another still reads its partial maxima.
  cluster.sync();
}

// How a batch of (height, width) frames is split: blocks per frame, rows
// per block, threads per block, whether the fields fit in shared memory,
// and the dynamic shared bytes.
struct Plan {
  int cluster;
  int rows;
  int threads;
  bool on_chip;
  size_t shared;
  bool ok;
};

Plan make_plan(int batch, int height, int width) {
  Plan p = {};
  if (batch <= 0 || height <= 0 || width <= 0) return p;
  auto block_pixels = [&](int c) {
    return (long long)((height + c - 1) / c) * width;
  };
  int c = 1;
  while (c < kMaxCluster && block_pixels(c) > kTargetBlockPixels) c <<= 1;
  while (c < kMaxCluster && (long long)batch * c < kWantBlocks &&
         block_pixels(2 * c) >= kMinBlockPixels)
    c <<= 1;
  p.cluster = c;
  p.rows = (height + c - 1) / c;
  const long long shifts = (long long)p.rows * sizeof(int);
  const long long fields = block_pixels(c) * kFields * sizeof(float);
  p.on_chip = fields + shifts <= kMaxDynamicShared;
  p.shared = (size_t)(p.on_chip ? fields + shifts : shifts);
  const long long per_sm = kSharedPerSm / ((long long)p.shared + 1024);
  p.threads = per_sm >= 4 ? 256 : per_sm >= 2 ? 512 : kMaxThreads;
  p.ok = shifts <= kMaxDynamicShared && block_pixels(c) < (1LL << 30);
  return p;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <bool kInjected, int kVec, bool kOnChip>
cudaError_t launch(const Plan& plan, const float* image, float* out,
                   float* scratch, const float* params, const long long* seeds,
                   const Draws& draws, int batch, int height, int width,
                   cudaStream_t stream) {
  auto kernel = noise_chain_kernel<kInjected, kVec, kOnChip>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamicShared);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)batch * plan.cluster);
  config.blockDim = dim3(plan.threads);
  config.dynamicSmemBytes = plan.shared;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, image, out, scratch, params,
                            seeds, draws, height, width, plan.rows);
}

template <bool kInjected, int kVec>
cudaError_t launch_on(const Plan& plan, const float* image, float* out,
                      float* scratch, const float* params,
                      const long long* seeds, const Draws& draws, int batch,
                      int height, int width, cudaStream_t stream) {
  return plan.on_chip
             ? launch<kInjected, kVec, true>(plan, image, out, scratch, params,
                                             seeds, draws, batch, height,
                                             width, stream)
             : launch<kInjected, kVec, false>(plan, image, out, scratch,
                                              params, seeds, draws, batch,
                                              height, width, stream);
}

}  // namespace

// Floats of device scratch the launch needs for a batch of (height, width)
// frames: 0 when a block's slice fits in shared memory, -1 when the shape
// is not supported.
extern "C" long long noise_chain_scratch_floats(int batch, int height,
                                                int width) {
  const Plan plan = make_plan(batch, height, width);
  if (!plan.ok) return -1;
  return plan.on_chip ? 0 : (long long)kFields * batch * height * width;
}

// Returns the launch's cudaError (0 on success).
extern "C" int noise_chain_launch(
    const float* image, float* out, float* scratch, const float* params,
    const long long* seeds, const float* u_pois, const float* z_pois,
    const float* u_sp, const float* u_un, const float* u_ex,
    const float* z_gauss, const float* u_row, const float* z_row, int batch,
    int height, int width, void* stream) {
  const Draws draws{u_pois, z_pois, u_sp, u_un, u_ex, z_gauss, u_row, z_row};
  const Plan plan = make_plan(batch, height, width);
  if (!plan.ok) return (int)cudaErrorInvalidValue;
  const bool injected = u_pois != nullptr;
  const bool vec = width % 4 == 0 && aligned16(image) && aligned16(out) &&
                   aligned16(scratch) && aligned16(u_pois) &&
                   aligned16(z_pois) && aligned16(u_sp) && aligned16(u_un) &&
                   aligned16(u_ex) && aligned16(z_gauss);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (injected) {
    err = vec ? launch_on<true, 4>(plan, image, out, scratch, params, seeds,
                                   draws, batch, height, width, s)
              : launch_on<true, 1>(plan, image, out, scratch, params, seeds,
                                   draws, batch, height, width, s);
  } else {
    err = vec ? launch_on<false, 4>(plan, image, out, scratch, params, seeds,
                                    draws, batch, height, width, s)
              : launch_on<false, 1>(plan, image, out, scratch, params, seeds,
                                    draws, batch, height, width, s);
  }
  return (int)err;
}
