// Fused Gaussian splat: clean STEM frames from atom bins in one launch.
//
// Replaces: putting_dune_tpu/ops/splat_pallas.py `splat_render` (kernel
// body `_kernel`). Per image b, with integer bins bx, by in [0, S), the
// flipped row bin byf = S-1-by, weights w (0 for masked atoms) and the
// truncated Gaussian profile
//   prof(d) = exp(-0.5 (d / sigma)^2)  if |d| <= floor(4 sigma + 0.5), else 0
// it computes
//   image[y, x] = sum_k (w_k * profy(y - byf_k)) * profx(x - bx_k)
// in f32, in atom order, and returns image / max(max(image), 1e-20). The
// TPU kernel casts the factors to bf16 for its matrix unit; that trade is
// not carried over.
//
// What bounds it on an H100: the S*S f32 output written once (bins and
// weights are negligible). A dense contraction would do 2*K*S*S operations
// per image; a profile is zero beyond its radius (~19 pixels at S = 256),
// so an atom touches ~39^2 pixels and the kernel does that sparse work.
//
// Design: one thread block cluster per image (up to 16 blocks, each a band
// of rows), so the per-image peak never leaves the chip.
//   * A block builds the two profiles over the support only (one half: the
//     profile is even, prof(-d) = prof(d) bit for bit), then walks the
//     image's atoms a block-load at a time: each thread tests its atoms
//     against the band grown by the radii, and the hits are compacted into
//     shared memory in atom order (warp ballots, warp totals summed with
//     `__reduce_add_sync`). For each hit the block tabulates w * profy over
//     the band's rows, so the inner loop is one broadcast 16-byte shared
//     load per four rows.
//   * Thread t owns one column and R rows of the band and keeps their sums
//     in registers; each warp walks only the hits within a radius of its 32
//     columns (a ballot over the hit list), two at a time, and adds
//     (w * fy) * fx to each row: the expression and order of the plain
//     atom-order sum (a lane outside a hit's support adds +0), so the frame
//     is bit-equal to it.
//   * The block's maximum goes into its slot in every block of the cluster
//     (distributed shared memory); after one cluster barrier each block
//     reads its own slots, divides, and writes its band once, coalesced by
//     rows. No block touches another's memory after that barrier, so none
//     waits for the others to leave.
//   * The time of an image's blocks is a chain of loads, barriers and the
//     exchange, and at S = 512 one 1024-thread block fills an SM, so only a
//     few clusters fit on the card at once. The launch therefore runs as
//     many clusters as fit (asked once per frame size) and each loops over
//     its share of the images, reading the next image's widths and atoms
//     while it exchanges the current one's peak.
// Frames wider than 512 columns or bands taller than the rows a block holds
// are done in chunks: each chunk's sums go to the output, and the block
// divides its band in place once the cluster's peak is known.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxSize = 2048;  // ops/splat.py MAX_IMAGE_SIZE
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCols = 512;  // columns of a chunk
// A block's shared memory less room for the static arrays.
constexpr int kMaxDynamicShared = 232448 - 1024;

// How a batch of S x S frames is cut: blocks per image (cluster), rows per
// block (band), rows a thread sums in registers (R), row groups a block
// (G: thread t owns column t % cols and rows R * (t / cols) + [0, R) of a
// chunk of G * R rows), columns a chunk (cols, a multiple of 32), atoms a
// thread tests per compaction (P).
struct Plan {
  int cluster;
  int band;
  int rows;
  int groups;
  int cols;
  int per_thread;
  size_t shared;
};

Plan make_plan(int size) {
  Plan p;
  p.band = (size + kMaxCluster - 1) / kMaxCluster;
  p.rows = p.band <= 8 ? 8 : 16;
  p.cluster = (size + p.band - 1) / p.band;
  p.cols = min((size + 31) / 32 * 32, kMaxCols);
  p.groups = min((p.band + p.rows - 1) / p.rows, 2);
  const int threads = p.cols * p.groups;
  p.per_thread = threads <= kMaxThreads / 2 ? 2 : 1;
  // w * profy per (hit, chunk row); both half profiles; hit x, y, weight.
  const size_t atoms = (size_t)threads * p.per_thread;
  p.shared = (atoms * p.groups * p.rows + 2 * (size_t)size + 3 * atoms) *
             sizeof(float);
  return p;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
splat_render_kernel(const float* __restrict__ bx, const float* __restrict__ by,
                    const float* __restrict__ weights,
                    const float* __restrict__ sigma_x,
                    const float* __restrict__ sigma_y,
                    float* __restrict__ out, int batch, int num_atoms,
                    int size, int band, int cols, int per_thread) {
  extern __shared__ float4 dyn4[];
  const int T = blockDim.x;
  const int A = T * per_thread;           // atoms a compaction takes
  const int chunk_rows = (T / cols) * R;  // a power of two
  const int row_shift = __ffs(chunk_rows) - 1;
  float* wfy = reinterpret_cast<float*>(dyn4);  // [A][chunk_rows]
  float* profx = wfy + A * chunk_rows;           // [size]
  float* profy = profx + size;                   // [size]
  int* hit_x = reinterpret_cast<int*>(profy + size);  // [A]
  int* hit_y = hit_x + A;                              // [A]
  float* hit_w = reinterpret_cast<float*>(hit_y + A);  // [A]
  __shared__ int warp_count[2][kMaxWarps];
  __shared__ float warp_max[kMaxWarps];
  // Every block's maximum, by the parity of the image's turn: a block may
  // write the next image's maxima while another still reads this one's.
  __shared__ float peaks[2][kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  // Every block of the cluster has started once the wait for this arrive
  // returns; only then may another block write into its shared memory.
  cluster_arrive_relaxed();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int clusters = gridDim.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  const int col = tid % cols, grp = tid / cols;
  const int wcol = col - lane;  // first column of this warp in a chunk
  const int y_begin = min(rank * band, size);
  const int y_end = min(y_begin + band, size);
  const int row_chunks = (y_end - y_begin + chunk_rows - 1) / chunk_rows;
  const int col_chunks = (size + cols - 1) / cols;
  const bool single = row_chunks == 1 && col_chunks == 1;

  // Global reads ahead of use: an image's widths and this thread's atoms
  // k0 + s * T + tid (its s-th of a compaction).
  float sx = 0.0f, sy = 0.0f;
  float abx[2] = {0.0f, 0.0f}, aby[2] = {0.0f, 0.0f}, aw[2] = {0.0f, 0.0f};
  auto load_atoms = [&](int img, int k0) {
    const size_t base = (size_t)img * num_atoms;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = k0 + s * T + tid;
      aw[s] = 0.0f;
      if (s < per_thread && k < num_atoms) {
        abx[s] = bx[base + k];
        aby[s] = by[base + k];
        aw[s] = weights[base + k];
      }
    }
  };
  auto load_image = [&](int img) {
    if (img >= batch) return;
    sx = sigma_x[img];
    sy = sigma_y[img];
    load_atoms(img, 0);
  };

  // A cluster takes images blockIdx.x / csize, then every `clusters`-th.
  int parity = 0;
  bool started = false;
  int b = blockIdx.x / csize;
  load_image(b);
  for (; b < batch; b += clusters, parity ^= 1) {
    // Radii, clamped to the largest distance inside a frame (a larger
    // radius admits the same pixels). The previous image's last reads of
    // the profiles came before a barrier.
    const int irx = (int)fminf(floorf(4.0f * sx + 0.5f), (float)(size - 1));
    const int iry = (int)fminf(floorf(4.0f * sy + 0.5f), (float)(size - 1));
    for (int d = tid; d <= irx; d += T) {
      const float q = (float)d / sx;
      profx[d] = expf(-0.5f * (q * q));
    }
    for (int d = tid; d <= iry; d += T) {
      const float q = (float)d / sy;
      profy[d] = expf(-0.5f * (q * q));
    }
    // (The first barrier of the atom loop orders these before any read.)

    float acc[R];
    float m = 0.0f;
    int y0 = y_begin, x = col;
    for (int rc = 0; rc < row_chunks; ++rc) {
      y0 = y_begin + rc * chunk_rows;
      const int rows = min(chunk_rows, y_end - y0);
      for (int cc = 0; cc < col_chunks; ++cc) {
        const int x0 = cc * cols;
        x = x0 + col;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;

        for (int k0 = 0; k0 < num_atoms; k0 += A) {
          // Compaction: each thread tests its atoms against the chunk
          // grown by the radii; hits keep atom order (sub-round s holds
          // atoms k0 + s * T + [0, T)).
          if (k0 > 0 || rc > 0 || cc > 0) load_atoms(b, k0);
          int ax[2], ay[2];
          unsigned ballot[2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            // Clamped as the plain versions clamp.
            ax[s] = min(max((int)abx[s], 0), size - 1);
            ay[s] = (size - 1) - min(max((int)aby[s], 0), size - 1);
            const bool hit = aw[s] != 0.0f && ay[s] + iry >= y0 &&
                             ay[s] - iry <= y0 + rows - 1 &&
                             ax[s] + irx >= x0 && ax[s] - irx <= x0 + cols - 1;
            ballot[s] = __ballot_sync(0xffffffffu, hit);
            if (lane == 0) warp_count[s][warp] = __popc(ballot[s]);
          }
          __syncthreads();
          int total = 0;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (s >= per_thread) break;
            const int c = lane < nwarps ? warp_count[s][lane] : 0;
            const int offset = total + (int)__reduce_add_sync(
                0xffffffffu, lane < warp ? (unsigned)c : 0u);
            total += (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
            if (ballot[s] >> lane & 1u) {
              const int slot =
                  offset + __popc(ballot[s] & ((1u << lane) - 1u));
              hit_x[slot] = ax[s];
              hit_y[slot] = ay[s];
              hit_w[slot] = aw[s];
            }
          }
          __syncthreads();
          for (int e = tid; e < total * chunk_rows; e += T) {
            const int i = e >> row_shift, r = e & (chunk_rows - 1);
            const int d = abs(y0 + r - hit_y[i]);
            wfy[e] = hit_w[i] * (d <= iry ? profy[d] : 0.0f);
          }
          __syncthreads();

          // Each warp walks only the hits that reach its 32 columns, two
          // at a time. A lane outside a hit's support adds (w * fy) * 0 =
          // +0, which changes no bit of its non-negative sum.
          const float4* wfy4 =
              reinterpret_cast<const float4*>(wfy + grp * R);
          const int lo = x0 + wcol, hi = lo + 31;
          auto fx_of = [&](int i) {
            const int dx = abs(x - hit_x[i]);
            return dx <= irx ? profx[min(dx, irx)] : 0.0f;
          };
          auto apply = [&](int i, float fx) {
            const float4* q4 = wfy4 + i * (chunk_rows / 4);
#pragma unroll
            for (int r4 = 0; r4 < R / 4; ++r4) {
              const float4 q = q4[r4];
              acc[4 * r4 + 0] = acc[4 * r4 + 0] + q.x * fx;
              acc[4 * r4 + 1] = acc[4 * r4 + 1] + q.y * fx;
              acc[4 * r4 + 2] = acc[4 * r4 + 2] + q.z * fx;
              acc[4 * r4 + 3] = acc[4 * r4 + 3] + q.w * fx;
            }
          };
          for (int base = 0; base < total; base += 32) {
            bool near = false;
            if (base + lane < total) {
              const int hx = hit_x[base + lane];
              near = hx + irx >= lo && hx - irx <= hi;
            }
            unsigned mask = __ballot_sync(0xffffffffu, near);
            while (mask) {
              const int i0 = base + __ffs(mask) - 1;
              mask &= mask - 1;
              if (mask) {
                const int i1 = base + __ffs(mask) - 1;
                mask &= mask - 1;
                const float f0 = fx_of(i0), f1 = fx_of(i1);
                apply(i0, f0);
                apply(i1, f1);
              } else {
                apply(i0, fx_of(i0));
              }
            }
          }
          __syncthreads();  // before the next chunk overwrites the hits
        }

        if (x < size) {
          const int r0 = grp * R;
          float* dst = out + ((size_t)b * size + y0 + r0) * size + x;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r0 + r < rows) {
              m = fmaxf(m, acc[r]);
              if (!single) dst[(size_t)r * size] = acc[r];
            }
          }
        }
      }
    }
    // The next image's reads go out now and land during the exchange.
    load_image(b + clusters);

    // The image's peak: the block's maximum goes into slot `rank` of every
    // block of the cluster; after the barrier each block reads its own
    // slots.
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (!started) cluster_wait();
    started = true;
    if (warp == 0) {
      float bm = lane < nwarps ? warp_max[lane] : 0.0f;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, s));
      if (lane < csize)
        *cluster.map_shared_rank(&peaks[parity][rank], lane) = bm;
    }
    cluster.sync();  // also makes the chunks' stores visible to the block
    float peak = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < csize) peak = fmaxf(peak, peaks[parity][r]);
    peak = fmaxf(peak, 1e-20f);

    if (single) {
      if (x < size) {
        const int r0 = grp * R;
        float* dst = out + ((size_t)b * size + y0 + r0) * size + x;
        const int rows = y_end - y0 - r0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows) dst[(size_t)r * size] = acc[r] / peak;
      }
    } else {
      float* dst = out + ((size_t)b * size + y_begin) * size;
      const int n = (y_end - y_begin) * size;
      for (int p = tid; p < n; p += T) dst[p] = dst[p] / peak;
    }
  }
  // Pair the first arrive even where a cluster got no image. After the last
  // barrier no block touches another's memory, so none waits to leave.
  if (!started) cluster_wait();
}

template <int R>
cudaError_t launch(const Plan& plan, const float* bx, const float* by,
                   const float* weights, const float* sigma_x,
                   const float* sigma_y, float* out, int batch, int num_atoms,
                   int size, cudaStream_t stream) {
  auto kernel = splat_render_kernel<R>;
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
  config.blockDim = dim3(plan.cols * plan.groups);
  config.dynamicSmemBytes = plan.shared;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  // As many clusters as the card holds at once (asked once per plan), each
  // looping over its share of the images.
  config.gridDim = dim3((unsigned)batch * plan.cluster);
  static int resident[kMaxSize + 1] = {};  // by frame size: the plan's key
  int& fit = resident[size];
  if (fit == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&fit, kernel, &config);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  config.gridDim = dim3((unsigned)min(batch, fit) * plan.cluster);
  return cudaLaunchKernelEx(&config, kernel, bx, by, weights, sigma_x, sigma_y,
                            out, batch, num_atoms, size, plan.band, plan.cols,
                            plan.per_thread);
}

}  // namespace

// Returns the launch's cudaError (0 on success).
extern "C" int splat_render_launch(const float* bx, const float* by,
                                   const float* weights, const float* sigma_x,
                                   const float* sigma_y, float* out, int batch,
                                   int num_atoms, int size, void* stream) {
  if (batch <= 0 || size <= 0 || size > kMaxSize || num_atoms < 0)
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(size);
  if (plan.shared > (size_t)kMaxDynamicShared)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (plan.rows == 8)
    err = launch<8>(plan, bx, by, weights, sigma_x, sigma_y, out, batch,
                    num_atoms, size, s);
  else
    err = launch<16>(plan, bx, by, weights, sigma_x, sigma_y, out, batch,
                     num_atoms, size, s);
  return (int)err;
}
