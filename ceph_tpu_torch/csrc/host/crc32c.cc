// CRC32-C (Castagnoli), used by the wire protocol frame checksums
// (the v2 protocol's crc sections) and object-store data checksums.
// Software table-sliced implementation with SSE4.2 hardware path.
// Host code, not a device kernel: ceph_tpu_torch/native.py builds it with
// the host C++ compiler at first use and loads it with ctypes.

#include <cstdint>
#include <cstddef>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

constexpr uint32_t kPolyRev = 0x82f63b78;  // reversed Castagnoli

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c & 1) ? (c >> 1) ^ kPolyRev : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; s++) {
        c = t[0][c & 0xff] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};

const Crc32cTable& table() {
  static Crc32cTable tb;
  return tb;
}

uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  const Crc32cTable& tb = table();
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(p[0]) | (p[1] << 8) | (p[2] << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(p[4]) | (p[5] << 8) | (p[6] << 16) |
                  (static_cast<uint32_t>(p[7]) << 24);
    crc = tb.t[7][crc & 0xff] ^ tb.t[6][(crc >> 8) & 0xff] ^
          tb.t[5][(crc >> 16) & 0xff] ^ tb.t[4][crc >> 24] ^
          tb.t[3][hi & 0xff] ^ tb.t[2][(hi >> 8) & 0xff] ^
          tb.t[1][(hi >> 16) & 0xff] ^ tb.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = tb.t[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  while (n >= 8) {
    uint64_t v;
    __builtin_memcpy(&v, p, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
    p += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}
#endif

}  // namespace

extern "C" {

uint32_t ceph_crc32c(uint32_t crc, const uint8_t* data, size_t n) {
#if defined(__x86_64__)
  static const bool have = __builtin_cpu_supports("sse4.2");
  if (have) return crc_hw(crc, data, n);
#endif
  return crc_sw(crc, data, n);
}

// Batched entry: checksum n buffers laid out in `data`, buffer i at
// [offsets[i], offsets[i] + lens[i]).  crcs[i] is the seed on entry
// and the result on return.  One library call amortizes the ctypes
// marshaling that dominates the per-buffer path for small buffers.
void ceph_crc32c_batch(uint32_t* crcs, const uint8_t* data,
                       const uint64_t* offsets, const uint64_t* lens,
                       int n) {
  for (int i = 0; i < n; i++)
    crcs[i] = ceph_crc32c(crcs[i], data + offsets[i],
                          static_cast<size_t>(lens[i]));
}

// Scattered variant: per-buffer pointers instead of one concatenated
// blob -- the host skips the join memcpy entirely and the buffers are
// read in place (wins once buffers are big enough that copying them
// costs more than building the pointer table).
void ceph_crc32c_batch_ptrs(uint32_t* crcs, const uint8_t* const* ptrs,
                            const uint64_t* lens, int n) {
  for (int i = 0; i < n; i++)
    crcs[i] = ceph_crc32c(crcs[i], ptrs[i],
                          static_cast<size_t>(lens[i]));
}

}  // extern "C"
