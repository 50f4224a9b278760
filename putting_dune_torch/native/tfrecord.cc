// Native TFRecord codec: length-delimited records with masked CRC32C.
//
// Upstream putting-dune does record IO through TensorFlow's TFRecord
// reader/writer (putting_dune/io.py:45-83). This is the port's native
// equivalent: a small, dependency-free C++ implementation of the
// same wire format (8-byte little-endian length + masked crc32c(length) +
// payload + masked crc32c(payload)), exposed through a C ABI for ctypes.
//
// Built at first use by putting_dune_torch/io/native.py (g++ -O3 -shared,
// with riegeli_hash.cc, into the git-ignored putting_dune_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Software CRC32C (Castagnoli), 8 tables (slicing-by-8).
uint32_t kTables[8][256];
bool tables_ready = false;

void InitTables() {
  if (tables_ready) return;
  const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    }
    kTables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = kTables[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = kTables[0][crc & 0xFF] ^ (crc >> 8);
      kTables[t][i] = crc;
    }
  }
  tables_ready = true;
}

uint32_t Crc32c(const uint8_t* data, size_t n, uint32_t crc = 0) {
  InitTables();
  crc = ~crc;
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(data[0]) |
           (static_cast<uint32_t>(data[1]) << 8) |
           (static_cast<uint32_t>(data[2]) << 16) |
           (static_cast<uint32_t>(data[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(data[4]) |
                  (static_cast<uint32_t>(data[5]) << 8) |
                  (static_cast<uint32_t>(data[6]) << 16) |
                  (static_cast<uint32_t>(data[7]) << 24);
    crc = kTables[7][crc & 0xFF] ^ kTables[6][(crc >> 8) & 0xFF] ^
          kTables[5][(crc >> 16) & 0xFF] ^ kTables[4][(crc >> 24) & 0xFF] ^
          kTables[3][hi & 0xFF] ^ kTables[2][(hi >> 8) & 0xFF] ^
          kTables[1][(hi >> 16) & 0xFF] ^ kTables[0][(hi >> 24) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) {
    crc = kTables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  }
  return ~crc;
}

// TFRecord "masked" crc.
inline uint32_t Mask(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}
inline uint32_t Unmask(uint32_t masked) {
  uint32_t rot = masked - 0xa282ead8u;
  return (rot >> 17) | (rot << 15);
}

}  // namespace

extern "C" {

// Writes n records to a new file with one open: record i is
// data[offsets[i]:offsets[i+1]]. Returns 0 on success.
int pd_tfrecord_write_many(const char* path, const uint8_t* data,
                           const uint64_t* offsets, uint64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  bool ok = true;
  for (uint64_t i = 0; ok && i < n; ++i) {
    const uint8_t* payload = data + offsets[i];
    uint64_t len = offsets[i + 1] - offsets[i];
    uint32_t len_crc = Mask(Crc32c(reinterpret_cast<uint8_t*>(&len), 8));
    uint32_t data_crc = Mask(Crc32c(payload, len));
    ok = fwrite(&len, 8, 1, f) == 1 && fwrite(&len_crc, 4, 1, f) == 1 &&
         (len == 0 || fwrite(payload, 1, len, f) == len) &&
         fwrite(&data_crc, 4, 1, f) == 1;
  }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : 2;
}

// Reads all records from a file. Two-phase API:
//   1. pd_tfrecord_scan(path, &num, &total_bytes) -> sizes
//   2. pd_tfrecord_read(path, buf, offsets) -> fills payloads + offsets
// offsets has num+1 entries (record i = buf[offsets[i]:offsets[i+1]]).
int pd_tfrecord_scan(const char* path, uint64_t* num_records,
                     uint64_t* total_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint64_t count = 0, total = 0;
  for (;;) {
    uint64_t len;
    if (fread(&len, 8, 1, f) != 1) break;  // EOF
    if (fseek(f, 4 + static_cast<long>(len) + 4, SEEK_CUR) != 0) {
      fclose(f);
      return 2;
    }
    count++;
    total += len;
  }
  fclose(f);
  *num_records = count;
  *total_bytes = total;
  return 0;
}

int pd_tfrecord_read(const char* path, uint8_t* buf, uint64_t* offsets,
                     uint64_t max_records, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint64_t pos = 0, i = 0;
  offsets[0] = 0;
  while (i < max_records) {
    uint64_t len;
    uint32_t len_crc, data_crc;
    if (fread(&len, 8, 1, f) != 1) break;
    if (fread(&len_crc, 4, 1, f) != 1) { fclose(f); return 2; }
    if (verify_crc &&
        Unmask(len_crc) != Crc32c(reinterpret_cast<uint8_t*>(&len), 8)) {
      fclose(f);
      return 3;
    }
    if (len > 0 && fread(buf + pos, 1, len, f) != len) {
      fclose(f);
      return 2;
    }
    if (fread(&data_crc, 4, 1, f) != 1) { fclose(f); return 2; }
    if (verify_crc && Unmask(data_crc) != Crc32c(buf + pos, len)) {
      fclose(f);
      return 4;
    }
    pos += len;
    ++i;
    offsets[i] = pos;
  }
  fclose(f);
  return 0;
}

}  // extern "C"
