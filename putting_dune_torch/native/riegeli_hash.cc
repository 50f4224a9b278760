// HighwayHash-64 entry point for the riegeli record codec.
//
// riegeli chunk/block headers carry HighwayHash-64 digests (key =
// "Riegeli/" "records\n" repeated, little-endian u64s; block-header hash
// covers header bytes [8,24), chunk-header hash covers bytes [8,40),
// data hash covers the logical chunk data). The hash itself is the
// canonical portable implementation from google/highwayhash, vendored
// under third_party/highwayhash (see its README).
//
// Exposed C ABI (consumed via ctypes from io/riegeli_native.py):
//   uint64_t pd_highwayhash64(const uint64_t key[4],
//                             const char* bytes, uint64_t size);

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "highwayhash/hh_portable.h"

extern "C" uint64_t pd_highwayhash64(const uint64_t key[4],
                                     const char* bytes, uint64_t size) {
  using highwayhash::HHPacket;
  using highwayhash::HHResult64;
  highwayhash::HH_TARGET_NAME::HHStatePortable state(key);
  const uint64_t remainder = size & (sizeof(HHPacket) - 1);
  const uint64_t truncated = size - remainder;
  // Copy each packet into an aligned local buffer: reinterpret_casting
  // arbitrary input offsets to HHPacket& is undefined behavior (alignment
  // + aliasing) and miscompiles under -O3.
  HHPacket packet HH_ALIGNAS(32);
  for (uint64_t offset = 0; offset < truncated; offset += sizeof(HHPacket)) {
    memcpy(packet, bytes + offset, sizeof(HHPacket));
    state.Update(packet);
  }
  if (remainder != 0) {
    state.UpdateRemainder(bytes + truncated, remainder);
  }
  HHResult64 result;
  state.Finalize(&result);
  return result;
}
