// CLAHE bilinear remap through the four surrounding tile LUTs.
//
// Replaces: putting_dune_tpu/ops/clahe_fused_pallas.py
// `_remap_natural_kernel` (third pallas_call of `clahe_fused_large_natural`)
// and `_remap_kernel` (the dual-block remap of `clahe_fused_large`, which
// the TPU package keeps for tiles narrower than 64 pixels). The number of
// gray levels V = nbins is a run-time argument. For output pixel (y, x)
// it takes the half-tile-offset dual block that holds (y + th/2, x + tw/2) in the
// edge-padded frame, the in-block weights fy = (row_in_block + 0.5) / th
// and fx likewise, the four corner tiles (i-1, j-1) .. (i, j) with the
// corner indices clamped to the grid, and returns
//   (1-fy)(1-fx) L00[bin] + (1-fy) fx L01[bin] + fy (1-fx) L10[bin]
//   + fy fx L11[bin]
// exactly as putting_dune_tpu/imaging/clahe.py does on the CPU. The LUTs
// stay f32 (the TPU route quantizes its blended LUTs to bf16).
//
// What bounds it on an H100: bytes. The frame is read once and written
// once (8 bytes/pixel) and the arithmetic is ~25 instructions a pixel;
// what can get in the way is the four LUT reads per pixel at a random bin,
// which from device memory or L2 are four 32-byte sectors for 16 useful
// bytes. Design:
//
//   * A block works on one row of dual blocks of one image: the th frame
//     rows whose two tile rows (i-1, i) are the same. Those rows are
//     contiguous in the natural layout, so the block reads and writes whole
//     frame rows with 16-byte accesses, four pixels a thread, and needs no
//     blocked copy of the frame.
//   * The block first copies the two tile rows' mappings into shared
//     memory, interleaved as one `float2` (upper tile, lower tile) per
//     (tile column, bin): 8 g V bytes, 16 KB at grid 8 and 256 bins. A
//     pixel then reads two `float2` from shared memory (its left and right
//     tile column at its bin). Neighbouring dual blocks of the row share
//     a tile column, which the table holds once; that matters for 32-pixel
//     tiles, where a dual block has only 1,024 pixels.
//   * A table larger than 48 KB (1,024 bins, or a wide grid) is walked in
//     passes over groups of dual-block columns; a band is split over several
//     blocks when the batch alone gives the card too few.
//   * A thread keeps its columns for the whole band, so the dual-block
//     column, the clamped tile columns and the fx weights are worked out
//     once; the pixel loop has no integer division. fy and fx are the same
//     true divisions as in the twin, so the result is bit-equal to it.
//
// Tensor cores, TMA and `wgmma` have no work here: a gather by data-dependent
// bin is not a tile copy, and there is no matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Shared memory of one pass's table: the default limit, so that several
// blocks stay resident on an SM.
constexpr int kTableBytes = 48 * 1024;
// Blocks wanted on the card before a band is left whole.
constexpr int kWantBlocks = 2 * 132;

struct Geometry {
  int height, width, grid, nbins;
  int split;          // blocks per band.
  int cols_per_pass;  // dual-block columns per pass of the table.
  int lanes_x;        // threads along a row (a power of two <= kThreads).
  bool vec_table;     // the mappings can be read as 16-byte vectors.
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
clahe_remap_kernel(const float* __restrict__ image,
                   const float* __restrict__ mapping, float* __restrict__ out,
                   Geometry geo) {
  extern __shared__ __align__(16) float2 table[];  // (tile column, bin)
  const int height = geo.height, width = geo.width, grid = geo.grid;
  const int nbins = geo.nbins;
  const int th = height / grid, tw = width / grid;

  int id = blockIdx.x;
  const int part = id % geo.split;
  id /= geo.split;
  const int bi = id % (grid + 1);  // dual-block row.
  const int b = id / (grid + 1);

  // Frame rows of the band, and this block's share of them.
  const int band_lo = max(bi * th - th / 2, 0);
  const int band_hi = min((bi + 1) * th - th / 2, height);
  const int per = (band_hi - band_lo + geo.split - 1) / geo.split;
  const int y_lo = band_lo + part * per;
  const int y_hi = min(y_lo + per, band_hi);
  const int i0 = min(max(bi - 1, 0), grid - 1), i1 = min(bi, grid - 1);
  const float* lut0 = mapping + ((size_t)b * grid + i0) * grid * nbins;
  const float* lut1 = mapping + ((size_t)b * grid + i1) * grid * nbins;

  const int tx = threadIdx.x & (geo.lanes_x - 1);
  const int ty = threadIdx.x / geo.lanes_x;
  const int lanes_y = kThreads / geo.lanes_x;
  const size_t frame = (size_t)b * height * width;

  for (int c0 = 0; c0 <= grid; c0 += geo.cols_per_pass) {
    const int c1 = min(c0 + geo.cols_per_pass, grid + 1);
    // Tile columns the dual-block columns [c0, c1) touch.
    const int t0 = max(c0 - 1, 0), t1 = min(c1 - 1, grid - 1);
    if (c0 > 0) __syncthreads();  // the previous pass still reads the table.
    // The mappings of tile columns t0..t1 are contiguous in each tile row.
    const int entries = (t1 - t0 + 1) * nbins;
    const float* src0 = lut0 + t0 * nbins;
    const float* src1 = lut1 + t0 * nbins;
    if (geo.vec_table) {
      for (int e = threadIdx.x * 4; e < entries; e += kThreads * 4) {
        const float4 a = *reinterpret_cast<const float4*>(src0 + e);
        const float4 c = *reinterpret_cast<const float4*>(src1 + e);
        float4* dst = reinterpret_cast<float4*>(table + e);
        dst[0] = make_float4(a.x, c.x, a.y, c.y);
        dst[1] = make_float4(a.z, c.z, a.w, c.w);
      }
    } else {
      for (int e = threadIdx.x; e < entries; e += kThreads)
        table[e] = make_float2(src0[e], src1[e]);
    }
    __syncthreads();

    const int x_lo = max(c0 * tw - tw / 2, 0);
    const int x_hi = min(c1 * tw - tw / 2, width);
    const int groups = (x_hi - x_lo) / kVec;
    for (int g = tx; g < groups; g += geo.lanes_x) {
      const int x = x_lo + g * kVec;
      const int xx = x + tw / 2;
      const int bj = xx / tw;  // dual-block column of all kVec pixels.
      const int j0 = min(max(bj - 1, 0), grid - 1), j1 = min(bj, grid - 1);
      const float2* left = table + (j0 - t0) * nbins;
      const float2* right = table + (j1 - t0) * nbins;
      float fx[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        fx[k] = ((float)(xx - bj * tw + k) + 0.5f) / (float)tw;

      for (int y = y_lo + ty; y < y_hi; y += lanes_y) {
        const float fy = ((float)(y + th / 2 - bi * th) + 0.5f) / (float)th;
        const size_t at = frame + (size_t)y * width + x;
        float px[kVec], res[kVec];
        if constexpr (kVec == 4) {
          const float4 q = *reinterpret_cast<const float4*>(image + at);
          px[0] = q.x, px[1] = q.y, px[2] = q.z, px[3] = q.w;
        } else {
          px[0] = image[at];
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int bin =
              min(max((int)(px[k] * (float)nbins), 0), nbins - 1);
          const float2 l = left[bin], r = right[bin];
          const float w00 = (1.0f - fy) * (1.0f - fx[k]);
          const float w01 = (1.0f - fy) * fx[k];
          const float w10 = fy * (1.0f - fx[k]);
          const float w11 = fy * fx[k];
          res[k] = l.x * w00 + r.x * w01 + l.y * w10 + r.y * w11;
        }
        if constexpr (kVec == 4) {
          *reinterpret_cast<float4*>(out + at) =
              make_float4(res[0], res[1], res[2], res[3]);
        } else {
          out[at] = res[0];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int clahe_remap_launch(const float* image, const float* mapping,
                                  float* out, int batch, int height, int width,
                                  int grid, int nbins, void* stream) {
  if (batch <= 0 || grid <= 0 || nbins <= 0 || height % grid || width % grid)
    return (int)cudaErrorInvalidValue;
  const int th = height / grid, tw = width / grid;
  Geometry geo{height, width, grid, nbins, 1, 1, 1,
               nbins % 4 == 0 && aligned16(mapping)};
  // Two tile columns per dual-block column at the least.
  const int tile_cols = kTableBytes / (nbins * (int)sizeof(float2));
  if (tile_cols < 2) return (int)cudaErrorInvalidValue;
  geo.cols_per_pass = min(tile_cols - 1, grid + 1);
  // Four pixels a thread where a group of four never straddles two dual
  // blocks (tw / 2 a multiple of 4) and the rows are 16-byte aligned.
  const bool vec = tw % 8 == 0 && aligned16(image) && aligned16(out);
  const int vw = vec ? 4 : 1;
  const long long bands = (long long)batch * (grid + 1);
  if (bands < kWantBlocks)
    geo.split = (int)min((long long)max(th / 8, 1),
                         (kWantBlocks + bands - 1) / bands);
  const int pass_cols = min(geo.cols_per_pass * tw, width) / vw;
  while (geo.lanes_x < kThreads && geo.lanes_x < pass_cols) geo.lanes_x <<= 1;
  const size_t shared =
      (size_t)min(geo.cols_per_pass + 1, grid) * nbins * sizeof(float2);
  const unsigned blocks = (unsigned)(bands * geo.split);
  if (vec) {
    clahe_remap_kernel<4><<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
        image, mapping, out, geo);
  } else {
    clahe_remap_kernel<1><<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
        image, mapping, out, geo);
  }
  return (int)cudaGetLastError();
}
