// K3 xor_sched: a compiled XOR schedule applied to a batch of stripes, for
// Hopper (sm_90a).
//
// Replaces ceph_tpu/ops/xor_schedule.py _compiled_sched_pallas (its body
// _sched_pallas_kernel_body and the core apply_bits_traced).  For an (r,k)
// GF(2^8) coefficient matrix M with (8r,8k) bit matrix W, the schedule is a
// CSE-minimised list of SSA XORs that computes the 8r output bit planes from
// the 8k input bit planes (plane 8j+s = bit s of chunk j; output value 8i+t
// is bit t of output row i; output -1 is a zero row, an output that is an
// input id is a copy).  data (B,k,L) uint8 -> out (B,r,L) uint8, byte for
// byte equal to the host oracle gf_matmul.
//
// This header holds everything but the schedule.  ops/xor_sched_codegen.py
// emits one source per schedule digest that includes it, defines a Body
// whose operator() is the schedule as straight-line code, and instantiates
// the entry with XOR_SCHED_ENTRY.  A loop over a runtime op list would not
// keep its values in registers; straight-line code does, as the TPU kernel
// bakes the schedule into its trace.
//
// Layout (bit-sliced): each thread owns 32 adjacent byte columns of one
// stripe.  It loads 32 bytes of each input row (two 16-byte loads),
// transposes them into 8 plane words (bit c of plane word s = bit s of byte
// c), runs the schedule's XORs on 32-bit words -- 32 columns per XOR, the
// least XOR work the schedule allows -- and, as soon as the 8 plane values of
// an output row exist, transposes them back to 32 bytes and stores them.
// Bound on the H100: HBM bytes for the sparse recovery matrices (n_terms
// XORs per 32 columns against ~3.4 integer ops per byte for each transpose);
// the 8k input planes stay live for the whole schedule, so large k (PMSR's
// 20 sub-rows = 160 planes) may exceed the register file and spill, which
// the build reports.  Any B and L: the ragged edge falls back to byte loads
// and stores, as do rows that are not 16-byte aligned.
//
// The same arithmetic also compiles as host C++ (no __CUDACC__), where the
// entry runs every thread in a loop: the CPU tests build it with the host
// compiler and hold it against the plain PyTorch version.

#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define XS_FN __device__ __forceinline__
#else
#define XS_FN inline
// host twin of the CUDA byte-permute intrinsic (selector bit 3 unused here)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = static_cast<uint64_t>(y) << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xffu) << (8 * i);
  return r;
}
#endif

namespace xor_sched {

constexpr int kThreads = 128;   // threads per block
constexpr int kCols = 32;       // byte columns per thread = bits of a plane word

// 4x4 byte transpose: out[c] byte j = in[j] byte c.
XS_FN void transpose4(const uint32_t* in, uint32_t* out) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// 8x8 bit transpose of the 8 bytes (lo = bytes 0-3, hi = bytes 4-7): bit c
// of byte s becomes bit s of byte c.  Three masked swaps (2x2, 4x4, 8x8
// blocks); only the last crosses the two words.
XS_FN void transpose8x8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu; lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu; hi ^= t ^ (t << 14);
  t = ((lo >> 4) ^ hi) & 0x0F0F0F0Fu;  hi ^= t; lo ^= t << 4;
}

// 32 bytes as 8 little-endian words (byte c = column c) -> 8 plane words
// (bit c of p[s] = bit s of byte c).
XS_FN void bytes_to_planes(const uint32_t* w, uint32_t* p) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    lo[g] = w[2 * g];
    hi[g] = w[2 * g + 1];
    transpose8x8(lo[g], hi[g]);   // byte s of group g = bits s of its 8 bytes
  }
  transpose4(lo, p);              // planes 0-3: byte g of p[s] from group g
  transpose4(hi, p + 4);          // planes 4-7
}

// The inverse of bytes_to_planes.
XS_FN void planes_to_bytes(const uint32_t* p, uint32_t* w) {
  uint32_t lo[4], hi[4];
  transpose4(p, lo);
  transpose4(p + 4, hi);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    transpose8x8(lo[g], hi[g]);
    w[2 * g] = lo[g];
    w[2 * g + 1] = hi[g];
  }
}

XS_FN void load16(const uint8_t* src, uint32_t* w) {
#ifdef __CUDACC__
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#else
  std::memcpy(w, src, 16);
#endif
}

XS_FN void store16(uint8_t* dst, const uint32_t* w) {
#ifdef __CUDACC__
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
  std::memcpy(dst, w, 16);
#endif
}

// One thread's columns of one stripe: n valid byte columns from ``in`` (row 0
// of the stripe's input, at the thread's first column) and ``out``.
struct Io {
  const uint8_t* in;
  uint8_t* out;
  long long L;    // row stride
  int n;          // kCols, or fewer at the ragged edge
  bool vec;       // full and 16-byte aligned: vector loads and stores

  XS_FN void load(int j, uint32_t* p) const {
    const uint8_t* row = in + j * L;
    uint32_t w[8];
    if (vec) {
      load16(row, w);
      load16(row + 16, w + 4);
    } else {
      // constant indices only, so w stays in registers
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c % 4 == 0) w[c / 4] = 0;
        if (c < n) w[c / 4] |= static_cast<uint32_t>(row[c]) << (8 * (c % 4));
      }
    }
    bytes_to_planes(w, p);
  }

  XS_FN void store(int i, const uint32_t* p) const {
    uint8_t* row = out + i * L;
    uint32_t w[8];
    planes_to_bytes(p, w);
    if (vec) {
      store16(row, w);
      store16(row + 16, w + 4);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < n) row[c] = static_cast<uint8_t>(w[c / 4] >> (8 * (c % 4)));
    }
  }
};

// Thread gid of the flat (stripe, column group) index space.
template <class Body>
XS_FN Io thread_io(const uint8_t* data, uint8_t* out, long long L, long long groups,
                   long long gid, bool aligned) {
  const long long b = gid / groups;
  const long long c0 = (gid - b * groups) * kCols;
  const int n = L - c0 < kCols ? static_cast<int>(L - c0) : kCols;
  return Io{data + b * Body::K * L + c0, out + b * Body::R * L + c0, L, n,
            aligned && n == kCols};
}

inline bool aligned16(const void* data, const void* out, long long L) {
  return L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

#ifdef __CUDACC__

template <class Body>
__global__ void __launch_bounds__(kThreads)
xor_sched_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out, long long L,
                 long long groups, long long total, bool aligned) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= total) return;
  Body()(thread_io<Body>(data, out, L, groups, gid, aligned));
}

template <class Body>
int launch(const void* data, void* out, int B, int k, int r, long long L, int device,
           void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (B < 1 || k != Body::K || r != Body::R || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (L + kCols - 1) / kCols;
  const long long total = groups * B;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xor_sched_kernel<Body><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), L, groups, total,
      aligned16(data, out, L));
  return static_cast<int>(cudaGetLastError());
}

#define XOR_SCHED_ENTRY(NAME, BODY)                                                     \
  extern "C" int NAME(const void* data, void* out, int B, int k, int r, long long L,    \
                      int device, void* stream) {                                       \
    return xor_sched::launch<BODY>(data, out, B, k, r, L, device, stream);              \
  }

#else

template <class Body>
int run_host(const void* data, void* out, int B, int k, int r, long long L) {
  if (B < 1 || k != Body::K || r != Body::R || L < 1) return 1;
  const long long groups = (L + kCols - 1) / kCols;
  const bool aligned = aligned16(data, out, L);
  for (long long gid = 0; gid < groups * B; ++gid)
    Body()(thread_io<Body>(static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
                           L, groups, gid, aligned));
  return 0;
}

#define XOR_SCHED_ENTRY(NAME, BODY)                                                     \
  extern "C" int NAME(const void* data, void* out, int B, int k, int r, long long L,    \
                      int, void*) {                                                     \
    return xor_sched::run_host<BODY>(data, out, B, k, r, L);                            \
  }

#endif

}  // namespace xor_sched
