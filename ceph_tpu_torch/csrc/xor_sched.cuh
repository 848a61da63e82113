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
// (K, R, block size, launch bounds, and an operator() with the schedule's
// XORs written out) and instantiates the entry with XOR_SCHED_ENTRY.  A loop
// over a runtime op list would not keep its values in registers; XORs
// written out do, as the TPU kernel bakes the schedule into its trace.
//
// Layout (bit-sliced): each thread owns 32 adjacent byte columns of one
// stripe.  It loads 32 bytes of an input row (two 16-byte loads), transposes
// them into 8 plane words (bit c of plane word s = bit s of byte c), XORs
// 32-bit words -- 32 columns per XOR -- and, once the 8 plane values of an
// output row are final, transposes them back to 32 bytes and stores them.
// Two designs, chosen per digest by the generator's design_for:
//  * register (8k <= 48 input planes): the schedule's CSE'd XORs with all 8k
//    input planes live for the whole schedule; the fewest XORs.
//  * tiled (larger k): the bit-matrix rows in tiles of output rows.  A tile's
//    output planes are accumulators in registers; a runtime loop streams
//    the input rows past (the next row's loads in flight, a switch on the
//    row to its XORs), and each accumulator takes one 3-input XOR per
//    input row from a table of the XORs of the row's two nibbles of planes.
//    Live values are a tile's accumulators and one row's planes and table,
//    whatever k is, where the register design held all 8k planes (PMSR's 20
//    sub-rows: 160 planes and 40 temporaries in 255 registers, chains 85
//    XORs deep, 6.6x its HBM bound).  Written out as straight-line code
//    instead, the tiles spilled: ptxas hoisted every row's loads ahead of
//    the XORs.  With several tiles, each tile fetches the input rows again.
// Bound on the H100: HBM bytes, or the integer issue of the transposes
// (~68 instructions per 32-byte row) plus the XORs (64 INT32 lanes a clock
// a SM).  Any B and L: the ragged edge falls back to byte loads and stores,
// as do rows that are not 16-byte aligned.
//
// The same arithmetic also compiles as host C++ (no __CUDACC__), where the
// entry runs every thread in a loop (run_host): the CPU tests build it with
// the host compiler and hold it against the plain PyTorch version.

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

// One step of an 8x8 bit transpose done in every byte lane of two words at
// once: the bits of ``a`` under ``m << d`` trade places with those of ``b``
// under ``m``.
XS_FN void swap_bits(uint32_t& a, uint32_t& b, int d, uint32_t m) {
  const uint32_t t = ((a >> d) ^ b) & m;
  b ^= t;
  a ^= t << d;
}

// In each byte lane g, the 8x8 bit matrix whose row i is byte g of q[i] is
// transposed: bit b of byte g of q[s] becomes bit s of byte g of q[b].  Three
// rounds of block swaps (4x4, 2x2, 1x1 blocks), 12 swaps in all.
XS_FN void transpose_bits8(uint32_t* q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) swap_bits(q[i], q[i + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    swap_bits(q[i], q[i + 2], 2, 0x33333333u);
    swap_bits(q[i + 1], q[i + 3], 2, 0x33333333u);
  }
#pragma unroll
  for (int i = 0; i < 8; i += 2) swap_bits(q[i], q[i + 1], 1, 0x55555555u);
}

// 32 bytes as 8 little-endian words (byte c = column c) -> 8 plane words
// (bit c of p[s] = bit s of byte c): gather bytes b, 8+b, 16+b, 24+b into
// word b (two 4x4 byte transposes), then transpose the bits of each byte
// lane.  Both steps are their own inverse.
XS_FN void bytes_to_planes(const uint32_t* w, uint32_t* p) {
  const uint32_t even[4] = {w[0], w[2], w[4], w[6]};
  const uint32_t odd[4] = {w[1], w[3], w[5], w[7]};
  transpose4(even, p);
  transpose4(odd, p + 4);
  transpose_bits8(p);
}

// The inverse of bytes_to_planes.
XS_FN void planes_to_bytes(const uint32_t* p, uint32_t* w) {
  uint32_t q[8], even[4], odd[4];
#pragma unroll
  for (int s = 0; s < 8; ++s) q[s] = p[s];
  transpose_bits8(q);
  transpose4(q, even);
  transpose4(q + 4, odd);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    w[2 * g] = even[g];
    w[2 * g + 1] = odd[g];
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

  // the 32 bytes of input row j as 8 little-endian words (zeros past n)
  XS_FN void fetch(int j, uint32_t* w) const {
    const uint8_t* row = in + j * L;
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
  }

  // input row j as 8 plane words
  XS_FN void load(int j, uint32_t* p) const {
    uint32_t w[8];
    fetch(j, w);
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
__global__ void __launch_bounds__(Body::kThreads, Body::kMinBlocks)
xor_sched_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out, long long L,
                 long long groups, long long total, bool aligned) {
  const long long gid = static_cast<long long>(blockIdx.x) * Body::kThreads + threadIdx.x;
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
  const long long blocks = (total + Body::kThreads - 1) / Body::kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xor_sched_kernel<Body><<<static_cast<unsigned>(blocks), Body::kThreads, 0,
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
