// GIF's variable-width LZW, the compressor of the port's episode videos.
//
// putting_dune_torch/io/gif.py writes animated GIF89a; this is its image
// data compressor, a C ABI for ctypes. The code stream follows giflib's
// EGifCompressLine: codes start at min_code_size + 1 bits; after a code is
// written the width grows by one bit once the next free code reaches
// 1 << width (at most 12 bits); when the next free code would be 4095 a
// clear code is written instead and the table starts over. Codes are packed
// least significant bit first. io/gif.py holds the same algorithm in Python
// (lzw_encode_py), which the tests hold this one to byte for byte.
//
// Built at first use by putting_dune_torch/io/native.py (g++ -O3 -shared,
// with tfrecord.cc and riegeli_hash.cc, into the git-ignored
// putting_dune_torch/_build/).

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxCode = 4095;

struct BitWriter {
  uint8_t* out;
  uint64_t cap;
  uint64_t pos = 0;
  uint32_t acc = 0;
  int bits = 0;
  bool overflow = false;

  void Put(uint32_t code, int width) {
    acc |= code << bits;
    bits += width;
    while (bits >= 8) {
      Byte(static_cast<uint8_t>(acc & 0xFF));
      acc >>= 8;
      bits -= 8;
    }
  }

  void Byte(uint8_t b) {
    if (pos < cap) {
      out[pos] = b;
    } else {
      overflow = true;
    }
    ++pos;
  }

  void Flush() {
    if (bits > 0) Byte(static_cast<uint8_t>(acc & 0xFF));
    acc = 0;
    bits = 0;
  }
};

}  // namespace

extern "C" {

// Compresses n palette indices (each < 1 << min_code_size, 2 <= min_code_size
// <= 8) into out. Returns the number of bytes written, -1 when out is too
// small (cap n * 2 + 16 always suffices), or -2 on a bad argument.
int64_t pd_gif_lzw_encode(const uint8_t* pixels, uint64_t n,
                          int min_code_size, uint8_t* out, uint64_t cap) {
  if (min_code_size < 2 || min_code_size > 8) return -2;
  const uint32_t clear = 1u << min_code_size;
  const uint32_t eoi = clear + 1;
  // (prefix code, pixel) -> code, valid where stamp equals the generation.
  std::vector<uint16_t> table(static_cast<size_t>(kMaxCode + 1) * 256);
  std::vector<uint32_t> stamp(table.size(), 0);
  uint32_t generation = 1;
  uint32_t next = clear + 2;
  int width = min_code_size + 1;
  BitWriter w{out, cap};

  auto emit = [&](uint32_t code) {
    w.Put(code, width);
    if (next >= (1u << width) && width < 12) ++width;
  };

  w.Put(clear, width);
  if (n > 0) {
    uint32_t prefix = pixels[0];
    if (prefix >= clear) return -2;
    for (uint64_t i = 1; i < n; ++i) {
      const uint32_t k = pixels[i];
      if (k >= clear) return -2;
      const size_t key = static_cast<size_t>(prefix) * 256 + k;
      if (stamp[key] == generation) {
        prefix = table[key];
        continue;
      }
      emit(prefix);
      prefix = k;
      if (next >= kMaxCode) {
        emit(clear);
        next = clear + 2;
        width = min_code_size + 1;
        ++generation;
      } else {
        table[key] = static_cast<uint16_t>(next++);
        stamp[key] = generation;
      }
    }
    emit(prefix);
  }
  emit(eoi);
  w.Flush();
  if (w.overflow) return -1;
  return static_cast<int64_t>(w.pos);
}

}  // extern "C"
