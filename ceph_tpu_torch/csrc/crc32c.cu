// CRC32C of byte rows for Hopper (sm_90a): kernel K4 ``crc32c_chunks``.
//
// It replaces ceph_tpu/ops/crc32c_batch.py _crc_chunks_compiled, a jitted XLA
// program (not Pallas): (N, l) uint8 rows -> (N,) CRC32C registers
// (Castagnoli, reflected 0x82F63B78) from the given seed, raw, with no final
// XOR.  The reference runs one lane per row through an l/8-step slice-by-8
// loop; at the fused RS k=8,m=3 encode that is 11,264 rows of 16,384
// dependent steps, too few threads to fill 132 SMs.
//
// Bound on the H100: the bytes read, 1.476e9 B at the fused encode
// ((1024*11) rows x 131072 B) over 3.35 TB/s = 0.44 ms.  Beside it, one
// shared-memory table lookup per byte: 1.476e9 at 32 a clock per SM, 132 SMs,
// ~1.98 GHz = 0.18 ms, but only if no two lanes of a warp hit one bank.
//
// The design: a braid (as in zlib's braided CRC), walked by warps.
//   - A warp's unit of work is a span of W = 512 * rounds bytes of a row.  In
//     each 512-byte round lane j loads the 16-byte word j, so every warp load
//     covers 4 whole 128-byte lines.  The lane keeps four registers, one per
//     4-byte column q of its words: stream (j, q) sees a 4-byte word every 512
//     bytes, and the 508 bytes between belong to the other streams.  Its
//     tables fold that gap in, T'_m = M^508 . T_m (M the 32x32 GF(2) matrix of
//     one zero byte), so a stream still costs one lookup a byte (slice-by-4).
//   - No bank conflicts: each table entry is stored kCopies = 32 times, copy
//     c in bank c, and lane j reads copy j.  4 x 256 entries x 32 copies is
//     128 KB of shared memory, so one block of 1024 threads a SM.
//   - Loads are marked evict-first (__ldcs): each byte is read once.
//   - After its span a stream's register stands 16 j + 4 q bytes past the
//     span's end.  The four registers of a lane join by Horner with M^4, the
//     32 lanes by a shuffle tree with M^(16 * 2^i) (each matrix applied as 4
//     byte-table lookups); the span's register then moves to the row's end:
//     M^(W 2^i) for the set bits of the spans after it and M^-(508 + z), z the
//     zero bytes that pad the row's end to 16 bytes.  Both are applied by the
//     whole warp at once (lane b XORs in column b, then one __reduce_xor_sync),
//     and lane 0 XORs the result into the row's CRC with an atomic.  The
//     wrapper fills the CRCs with M^l . seed first, so every span starts from
//     register 0.
//   - A row's spans end at the row's end rounded up to 16 bytes and run
//     leftwards, the first of them reaching before the row's start: the bytes
//     before the row are zeros to the CRC (register 0 stays 0 over zeros), the
//     ones past its end are masked to zero and stripped by M^-z.  Only the
//     spans that touch either end take the masked loads.  A masked load reads
//     the whole aligned 16-byte word around a row's first or last byte; such
//     a word lies in the allocation's own 16-byte granule.
//   - A grid sized to the card (SMs x resident blocks) walks the (row, span)
//     items of up to two arrays of rows of one length, so a fused encode's
//     data and parity take one launch.
//
// Plain C interface for ctypes: the entry launches on the given device and
// stream, allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Without __CUDACC__ the kernel also compiles as host C++ (no launcher, no C
// entry): the includer supplies the CUDA built-ins it uses and runs each
// block's threads itself.  A CPU test builds it that way.

#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kCopies = 32;    // copies of each table entry (power of two <= 32)
constexpr int kUnroll = 2;     // rounds whose loads are issued before lookups
constexpr int kThreads = 1024; // threads a block
constexpr int kMinBlocks = 1;  // resident blocks a SM the registers allow

constexpr int kRound = 512;             // bytes a warp loads in one round
constexpr int kStepWords = 4 * 256;     // T'_0..T'_3, one copy
constexpr int kFolds = 6;               // M^4, then M^(16 * 2^i), i < 5
constexpr int kMaxLadder = 48;          // M^(W * 2^i), i < kMaxLadder
// the constants, in 32-bit words: T'_m[v] at m*256+v; the fold matrices as
// byte tables (1024 words each: A(v << 8k) at k*256+v); M^-(508+z) for z <
// 16 as 32 column words each; then the ladder's n_ladder matrices, likewise
constexpr int kConstFold = kStepWords;
constexpr int kConstTail = kConstFold + kFolds * 1024;
constexpr int kConstLadder = kConstTail + 16 * 32;
// shared memory, in words: the step tables in kCopies copies, then the rest
// of the constants as they are
constexpr int kSmemFold = kStepWords * kCopies;
constexpr int kSmemWords = kSmemFold + (kConstLadder - kConstFold) + 32 * kMaxLadder;

// table entry e of the step tables for copy c
__device__ __forceinline__ uint32_t look(const uint32_t* tab, int e, uint32_t c) {
  return tab[e * kCopies + c];
}

// one 4-byte step of a stream: x = register ^ word, then the gap
__device__ __forceinline__ uint32_t step4(const uint32_t* tab, uint32_t c, uint32_t x) {
  return look(tab, 3 * 256 + (x & 0xFFu), c) ^ look(tab, 2 * 256 + ((x >> 8) & 0xFFu), c) ^
         look(tab, 1 * 256 + ((x >> 16) & 0xFFu), c) ^ look(tab, x >> 24, c);
}

// A . v for a matrix stored as byte tables
__device__ __forceinline__ uint32_t apply_bytes(const uint32_t* t, uint32_t v) {
  return t[v & 0xFFu] ^ t[256 + ((v >> 8) & 0xFFu)] ^ t[512 + ((v >> 16) & 0xFFu)] ^
         t[768 + (v >> 24)];
}

// A . v for a warp-uniform v and A as 32 column words: lane b XORs in column b
__device__ __forceinline__ uint32_t apply_warp(const uint32_t* cols, uint32_t v, int lane) {
  return __reduce_xor_sync(0xffffffffu, cols[lane] & (0u - ((v >> lane) & 1u)));
}

// the 16-byte word at w (16-aligned); with kEdge the bytes outside [lo, hi)
// read as zeros and a word wholly before lo is not loaded
template <bool kEdge>
__device__ __forceinline__ uint4 load_word(const uint8_t* w, uintptr_t lo, uintptr_t hi) {
  const uint4* p = reinterpret_cast<const uint4*>(w);
  if (!kEdge) return __ldcs(p);
  const uintptr_t a = reinterpret_cast<uintptr_t>(w);
  uint4 v = {0u, 0u, 0u, 0u};
  if (a + 16 <= lo) return v;
  v = __ldcs(p);
  uint32_t* q = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t s = a + 4 * i;
    const uintptr_t lead = lo > s ? lo - s : 0, trail = s + 4 > hi ? s + 4 - hi : 0;
    const uint32_t keep =
        lead >= 4 || trail >= 4 ? 0u : (0xFFFFFFFFu << (8 * lead)) & (0xFFFFFFFFu >> (8 * trail));
    q[i] &= keep;
  }
  return v;
}

// the four stream registers of one lane over its words of a span
template <bool kEdge>
__device__ __forceinline__ void run_span(const uint32_t* tab, uint32_t c, const uint8_t* w,
                                         int rounds, uintptr_t lo, uintptr_t hi,
                                         uint32_t (&r)[4]) {
  int i = 0;
  for (; i + kUnroll <= rounds; i += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_word<kEdge>(w + (i + u) * kRound, lo, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[0] = step4(tab, c, r[0] ^ v[u].x);
      r[1] = step4(tab, c, r[1] ^ v[u].y);
      r[2] = step4(tab, c, r[2] ^ v[u].z);
      r[3] = step4(tab, c, r[3] ^ v[u].w);
    }
  }
  for (; i < rounds; ++i) {
    const uint4 v = load_word<kEdge>(w + i * kRound, lo, hi);
    r[0] = step4(tab, c, r[0] ^ v.x);
    r[1] = step4(tab, c, r[1] ^ v.y);
    r[2] = step4(tab, c, r[2] ^ v.z);
    r[3] = step4(tab, c, r[3] ^ v.w);
  }
}

// rows: na of a, then those of b, each of l bytes; out (na + nb,) int64
// holds M^l . seed on entry and each row's CRC on exit (the low word, at
// out[2 row] little-endian, takes the atomics); items = (na + nb) * spans
__global__ void __launch_bounds__(kThreads, kMinBlocks)
crc32c_rows_kernel(const uint8_t* __restrict__ a, long long na, const uint8_t* __restrict__ b,
                   uint32_t* __restrict__ out, long long l, int rounds, long long spans,
                   long long items, const uint32_t* __restrict__ consts, int n_ladder) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* fold = tab + kSmemFold;
  uint32_t* tail = fold + (kConstTail - kConstFold);
  uint32_t* ladder = fold + (kConstLadder - kConstFold);
  for (int i = threadIdx.x; i < kStepWords * kCopies; i += blockDim.x)
    tab[i] = consts[i / kCopies];
  for (int i = threadIdx.x; i < kConstLadder - kConstFold + 32 * n_ladder; i += blockDim.x)
    fold[i] = consts[kConstFold + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const uint32_t c = static_cast<uint32_t>(lane) & (kCopies - 1);
  const long long W = static_cast<long long>(rounds) * kRound;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long it = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       it < items; it += nwarps) {
    const long long row = it / spans, s = it - row * spans;
    const uint8_t* p = row < na ? a + row * l : b + (row - na) * l;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(p), hi = lo + static_cast<uintptr_t>(l);
    const uintptr_t end = (hi + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t start = end - static_cast<uintptr_t>((spans - s) * W);
    if (start + W <= lo) continue;   // wholly before the row: zeros
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    const uint8_t* w = reinterpret_cast<const uint8_t*>(start) + 16 * lane;
    if (start < lo || start + W > hi)
      run_span<true>(tab, c, w, rounds, lo, hi, r);
    else
      run_span<false>(tab, c, w, rounds, lo, hi, r);

    // lane: streams q at +16 lane + 4q, Horner with M^4 -> +16 lane + 12
    uint32_t acc = apply_bytes(fold, r[0]) ^ r[1];
    acc = apply_bytes(fold, acc) ^ r[2];
    acc = apply_bytes(fold, acc) ^ r[3];
    // warp: lane 2^(i+1) t takes lane 2^(i+1) t + 2^i -> lane 0 at +508
    for (int i = 0; i < 5; ++i) {
      const uint32_t right = __shfl_down_sync(0xffffffffu, acc, 1 << i);
      acc = apply_bytes(fold + 1024 * (1 + i), acc) ^ right;
    }
    uint32_t v = __shfl_sync(0xffffffffu, acc, 0);
    const unsigned long long after = static_cast<unsigned long long>(spans - 1 - s);
    for (int i = 0; (after >> i) != 0; ++i)
      if ((after >> i) & 1u) v = apply_warp(ladder + 32 * i, v, lane);
    v = apply_warp(tail + 32 * static_cast<int>(end - hi), v, lane);
    if (lane == 0) atomicXor(out + 2 * row, v);
  }
}

}  // namespace

#ifdef __CUDACC__

extern "C" {

// data: na rows at a, then nb rows at b (any alignment), l bytes each; out
// (na + nb,) int64 filled with M^l . seed; each row in spans of 512 * rounds
// bytes; consts as crc32c_rows_kernel reads them, n_ladder >= bit length of
// spans - 1 (on the device).
int crc32c_chunks(const void* a, long long na, const void* b, long long nb, void* out,
                  long long l, int rounds, long long spans, const void* consts, int n_ladder,
                  int device, void* stream) {
  static int blocks_per_sm[64], sms[64];
  constexpr size_t smem = kSmemWords * sizeof(uint32_t);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (device < 0 || device >= 64 || na < 1 || nb < 0 || (nb > 0 && b == nullptr) || l < 1 ||
      rounds < 1 || spans < 1 || n_ladder < 0 || n_ladder > kMaxLadder ||
      (n_ladder < 63 && static_cast<unsigned long long>(spans - 1) >> n_ladder) ||
      spans * rounds * kRound < l)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_per_sm[device] == 0) {
    cudaError_t e = cudaFuncSetAttribute(crc32c_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm[device],
                                                        crc32c_rows_kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks_per_sm[device] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long items = (na + nb) * spans;
  const long long want = (items + kThreads / 32 - 1) / (kThreads / 32);
  const long long full = static_cast<long long>(sms[device]) * blocks_per_sm[device];
  const unsigned blocks = static_cast<unsigned>(want < full ? want : full);
  crc32c_rows_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), na, static_cast<const uint8_t*>(b),
      static_cast<uint32_t*>(out), l, rounds, spans, items,
      static_cast<const uint32_t*>(consts), n_ladder);
  return static_cast<int>(cudaGetLastError());
}

// info = {registers a thread, dynamic shared memory bytes a block, resident
// blocks a SM, local memory bytes a thread} of the kernel on the device
int crc32c_config(int device, int* info) {
  constexpr size_t smem = kSmemWords * sizeof(uint32_t);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc32c_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, crc32c_rows_kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crc32c_rows_kernel, kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(smem);
  info[2] = blocks;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
