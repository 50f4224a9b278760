// Whole CLAHE of a frame with small tiles in one launch: a block per image,
// a warp per tile.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py `clahe_fused`
// (`_kernel`, with `_nibble_histograms`), the route for tiles of at most
// 512 pixels (128^2 and 64^2 frames at grid 8). For a (B, H, W) f32 batch,
// a grid x grid tile mesh and V = nbins gray levels it computes exactly
// what csrc/clahe_hist_lut.cu followed by csrc/clahe_remap.cu compute:
//   histogram  bins = clip(int(x * V), 0, V - 1); the g^2 tile histograms;
//   mapping    per tile: clip at clim = max(clip_limit * tile_pixels, 1),
//              spread the excess uniformly, cumsum, normalize;
//   remap      per pixel: bilinear blend of the four surrounding tiles'
//              mappings (half-tile-offset blocks, corners clamped to the
//              grid), in clahe_remap's order of operations.
//
// What bounds it on an H100: bytes, 8 a pixel (the frame read once from
// device memory, the result written once); at (256, 128, 128) that is
// 0.010 ms. A tile of at most 512 pixels carries ~500 instructions of
// mapping (clahe::tile_mapping) beside ~40 a pixel, so at these sizes the
// instructions weigh about as much as the bytes. The design keeps both
// lean and everything but the frame on chip:
//   * One block of 16 warps per image, two blocks an SM: 256 images fill
//     the card once. A block needs no other block, so there is no cluster
//     and no exchange; all g^2 mappings of the image sit in its shared
//     memory (64 KB at grid 8 and 256 bins).
//   * Histograms: a warp per tile (warps loop over the tiles), the tile
//     read with `float4` loads where the tile width is a multiple of 4 and
//     the frame aligned (one float a lane otherwise), counted with plain
//     shared-memory atomics into the tile's own slice; the first loads of
//     the warp's next tile are issued before this tile's mapping, so that
//     their latency hides behind it. The same warp turns the counts into
//     the mapping in place
//     with clahe::tile_mapping (csrc/clahe_lut.cuh, shared with
//     clahe_hist_lut, so both routes give the same mappings bit for bit).
//   * Remap: after one block barrier, warps walk whole frame rows (the
//     second read of the frame comes from L2: the block read it a moment
//     before), four pixels a lane. Each row's two tile rows and fy, and
//     each column's two tile columns and fx, come from tables built once per
//     block, so the pixel loop has no integer division; four mappings a
//     pixel are read from shared memory.
// Tensor cores, TMA and `wgmma` have no work here: a histogram and a gather
// by data-dependent bin are neither tile copies nor matrix products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clahe_lut.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kMaxTilePixels = 512;
constexpr int kMaxDynamicShared = 232448;

template <int kVec>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void get(T v, float (&o)[1]) { o[0] = v; }
  static __device__ __forceinline__ T make(const float (&o)[1]) {
    return o[0];
  }
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
  static __device__ __forceinline__ T make(const float (&o)[4]) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

// Where a pixel row or column sits in the dual-block layout: the offsets of
// its two tile rows (columns) in the mapping table and its in-block weight.
struct Axis {
  int lo, hi;
  float frac;
};

// kVec floats a vector, NB * 32 >= nbins. Two blocks an SM where the
// mapping's registers allow it (up to 256 bins).
template <int kVec, int NB>
__global__ void __launch_bounds__(32 * kWarps, NB <= 8 ? 2 : 1)
clahe_small_kernel(const float* __restrict__ image, float* __restrict__ out,
                   int* __restrict__ hist_out, int height, int width,
                   int grid, int nbins, float clim) {
  extern __shared__ __align__(16) float smem[];
  using V = Vec<kVec>;
  using VT = typename V::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int th = height / grid, tw = width / grid;
  const int tiles = grid * grid;
  const size_t frame = (size_t)b * height * width;
  const float fbins = (float)nbins;

  // Shared memory: the g^2 x V table (counts, then mappings), then the row
  // and column tables.
  float* maps = smem;
  Axis* rows = reinterpret_cast<Axis*>(smem + tiles * nbins);
  Axis* cols = rows + height;
  // Pixel (y, x) lies in the dual block (yy / th, xx / tw) of the padded
  // frame, yy = y + th / 2: tile rows i0 = max(bi - 1, 0), i1 = min(bi,
  // g - 1), fy = (yy - bi th + 0.5) / th, as clahe_remap computes them.
  for (int i = threadIdx.x; i < height + width; i += blockDim.x) {
    const bool row = i < height;
    const int t = row ? th : tw, p = (row ? i : i - height) + t / 2;
    const int blk = p / t;
    const int step = row ? grid * nbins : nbins;
    Axis a;
    a.lo = max(blk - 1, 0) * step;
    a.hi = min(blk, grid - 1) * step;
    a.frac = ((float)(p - blk * t) + 0.5f) / (float)t;
    rows[i] = a;  // the column entries follow the row entries
  }

  // ---- histograms and mappings, a warp per tile --------------------------
  const int row_vec = width / kVec;  // vectors in a frame row
  const int twv = tw / kVec;         // vectors in a tile row
  const int nvec = th * twv;
  // Vector q = lane + 32 i of a tile sits at row r, column c; each step of
  // 32 vectors moves (step_r, step_c), wrapping the column once.
  const int r_first = lane / twv, c_first = lane - r_first * twv;
  const int step_r = 32 / twv, step_c = 32 - step_r * twv;
  // A lane's vectors of a tile in batches of kBatch; the first batch of the
  // warp's next tile is loaded before the present tile's mapping, so that
  // its latency hides behind the mapping's work.
  constexpr int kBatch = kVec == 4 ? 2 : 4;
  auto tile_src = [&](int tile) {
    const int ty = tile / grid, tx = tile - ty * grid;
    return reinterpret_cast<const VT*>(image + frame +
                                       (size_t)ty * th * width + tx * tw);
  };
  auto load_batch = [&](const VT* src, int q0, int& r, int& c,
                        VT (&v)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (q0 + 32 * u + lane < nvec) v[u] = __ldg(src + (size_t)r * row_vec + c);
      r += step_r;
      c += step_c;
      if (c >= twv) {
        c -= twv;
        ++r;
      }
    }
  };
  VT batch[kBatch];
  int r = r_first, c = c_first;
  if (warp < tiles) load_batch(tile_src(warp), 0, r, c, batch);
  for (int tile = warp; tile < tiles; tile += kWarps) {
    int* hist = reinterpret_cast<int*>(maps + tile * nbins);
    for (int v = lane; v < nbins; v += 32) hist[v] = 0;
    __syncwarp();
    const VT* src = tile_src(tile);
    for (int q0 = 0;;) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q0 + 32 * u + lane >= nvec) continue;
        float px[kVec];
        V::get(batch[u], px);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          atomicAdd(&hist[min(max((int)(px[k] * fbins), 0), nbins - 1)], 1);
      }
      q0 += 32 * kBatch;
      if (q0 >= nvec) break;
      load_batch(src, q0, r, c, batch);
    }
    r = r_first;
    c = c_first;
    if (tile + kWarps < tiles)
      load_batch(tile_src(tile + kWarps), 0, r, c, batch);
    __syncwarp();
    // Each lane reads its own bins and writes its own mapping entries back
    // over them.
    int* dst = hist_out == nullptr
                   ? nullptr
                   : hist_out + ((size_t)b * tiles + tile) * nbins;
    float x[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int v = lane + 32 * j;
      int count = 0;
      if (v < nbins) {
        count = hist[v];
        if (dst != nullptr) dst[v] = count;
      }
      x[j] = (float)count;
    }
    clahe::tile_mapping<NB>(x, nbins, clim, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int v = lane + 32 * j;
      if (v < nbins) maps[tile * nbins + v] = x[j];
    }
  }
  __syncthreads();

  // ---- remap: a warp per frame row at a time, kVec pixels a lane ---------
  const VT* in_rows = reinterpret_cast<const VT*>(image + frame);
  VT* out_rows = reinterpret_cast<VT*>(out + frame);
  for (int y = warp; y < height; y += kWarps) {
    const Axis ry = rows[y];
    const float fy = ry.frac;
    for (int xv = lane; xv < row_vec; xv += 32) {
      float px[kVec], res[kVec];
      V::get(__ldg(in_rows + (size_t)y * row_vec + xv), px);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const Axis cx = cols[xv * kVec + k];
        const float fx = cx.frac;
        const int bin = min(max((int)(px[k] * fbins), 0), nbins - 1);
        const float w00 = (1.0f - fy) * (1.0f - fx);
        const float w01 = (1.0f - fy) * fx;
        const float w10 = fy * (1.0f - fx);
        const float w11 = fy * fx;
        res[k] = maps[ry.lo + cx.lo + bin] * w00 +
                 maps[ry.lo + cx.hi + bin] * w01 +
                 maps[ry.hi + cx.lo + bin] * w10 +
                 maps[ry.hi + cx.hi + bin] * w11;
      }
      out_rows[(size_t)y * row_vec + xv] = V::make(res);
    }
  }
}

size_t shared_bytes(int height, int width, int grid, int nbins) {
  return (size_t)grid * grid * nbins * sizeof(float) +
         (size_t)(height + width) * sizeof(Axis);
}

template <int kVec, int NB>
cudaError_t launch(const float* image, float* out, int* hist, int batch,
                   int height, int width, int grid, int nbins, float clim,
                   size_t shared, cudaStream_t stream) {
  auto kernel = clahe_small_kernel<kVec, NB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamicShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<batch, 32 * kWarps, shared, stream>>>(image, out, hist, height,
                                                 width, grid, nbins, clim);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t launch_nb(const float* image, float* out, int* hist, int batch,
                      int height, int width, int grid, int nbins, float clim,
                      size_t shared, cudaStream_t s) {
  if (nbins <= 128)
    return launch<kVec, 4>(image, out, hist, batch, height, width, grid,
                           nbins, clim, shared, s);
  if (nbins <= 256)
    return launch<kVec, 8>(image, out, hist, batch, height, width, grid,
                           nbins, clim, shared, s);
  if (nbins <= 512)
    return launch<kVec, 16>(image, out, hist, batch, height, width, grid,
                            nbins, clim, shared, s);
  return launch<kVec, 32>(image, out, hist, batch, height, width, grid,
                          nbins, clim, shared, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Dynamic shared memory a launch at this shape needs, in bytes.
extern "C" long long clahe_small_shared_bytes(int height, int width, int grid,
                                              int nbins) {
  return (long long)shared_bytes(height, width, grid, nbins);
}

// Returns the launch's cudaError (0 on success). `hist` may be null.
extern "C" int clahe_small_launch(const float* image, float* out, int* hist,
                                  int batch, int height, int width, int grid,
                                  int nbins, float clim, void* stream) {
  if (batch <= 0 || grid <= 0 || nbins < 2 || nbins > 1024 ||
      height % grid || width % grid ||
      (height / grid) * (width / grid) > kMaxTilePixels)
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_bytes(height, width, grid, nbins);
  if (shared > (size_t)kMaxDynamicShared) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // Four pixels a vector where a tile row is whole vectors (the remap's
  // rows then are too) and the frames are 16-byte aligned.
  const bool vec = (width / grid) % 4 == 0 && aligned16(image) &&
                   aligned16(out);
  return (int)(vec ? launch_nb<4>(image, out, hist, batch, height, width,
                                  grid, nbins, clim, shared, s)
                   : launch_nb<1>(image, out, hist, batch, height, width,
                                  grid, nbins, clim, shared, s));
}
