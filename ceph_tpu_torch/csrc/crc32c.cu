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
// shared-memory table lookup per byte: 1.476e9 at 32 a clock per SM, 132
// SMs, ~1.98 GHz = 0.18 ms if no two lanes of a warp hit one bank; the
// indices are data, so they do, and a first kernel lands a few times over
// the bound.
//
// The design is the reference's own host engine (_crc_rows_numpy): split
// each row into S = 2^log_s segments, checksum the segments in parallel, and
// fold the segment registers with GF(2) matrices.
//   - One thread per segment, S threads per row (the wrapper picks S so
//     rows x S is ~2^18 threads).  Segment 0 is the row's first
//     f = l - (S-1)*seg bytes and carries the seed; segments 1..S-1 are seg
//     bytes each (seg % 16 == 0) and start from 0.  The short or ragged part
//     is thus always the leftmost, so every right-hand node of the fold tree
//     covers whole segments.
//   - Slice-by-8 with the 8x256 tables in shared memory (8 KB a block),
//     32 bytes (two 16-byte loads, a whole DRAM sector) per iteration; the
//     unaligned head and the tail under 32 bytes take the byte table.
//   - The fold: CRC(A || B) = M^|B| . CRC(A) ^ CRC_0(B), M the 32x32 GF(2)
//     matrix of one zero byte.  Level i of a binary tree joins nodes of 2^i
//     segments with M^(seg*2^i), host-computed (the wrapper's copy of
//     _zeros_matrix) and read from shared memory as broadcasts: 32
//     conditional XORs per join.  Levels inside a warp use __shfl_down_sync;
//     rows wider than a warp finish in their first warp over the warps'
//     partial registers.
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

constexpr int kCrcMinThreads = 128;   // threads per block when S < 128
constexpr int kCrcMaxLogS = 10;       // at most 1024 segments (one block) a row
constexpr int kCrcTable = 8 * 256;    // slice-by-8 table words

// reg' = M . reg: XOR of the columns of m selected by reg's bits
__device__ __forceinline__ uint32_t mat_apply(const uint32_t* m, uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) acc ^= m[b] & (0u - ((v >> b) & 1u));
  return acc;
}

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* t, uint32_t crc,
                                             uint32_t byte) {
  return t[(crc ^ byte) & 0xFFu] ^ (crc >> 8);
}

// 8 bytes, lo = bytes 0..3 and hi = bytes 4..7 little-endian
__device__ __forceinline__ uint32_t crc_word8(const uint32_t* t, uint32_t crc,
                                              uint32_t lo, uint32_t hi) {
  crc ^= lo;
  return t[7 * 256 + (crc & 0xFFu)] ^ t[6 * 256 + ((crc >> 8) & 0xFFu)] ^
         t[5 * 256 + ((crc >> 16) & 0xFFu)] ^ t[4 * 256 + (crc >> 24)] ^
         t[3 * 256 + (hi & 0xFFu)] ^ t[2 * 256 + ((hi >> 8) & 0xFFu)] ^
         t[1 * 256 + ((hi >> 16) & 0xFFu)] ^ t[hi >> 24];
}

// The raw CRC register after len bytes at p, from crc.
__device__ __forceinline__ uint32_t crc_span(const uint32_t* t, uint32_t crc,
                                             const uint8_t* p, long long len) {
  while (len > 0 && (reinterpret_cast<uintptr_t>(p) & 15u)) {
    crc = crc_byte(t, crc, *p++);
    --len;
  }
  for (; len >= 32; len -= 32, p += 32) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
    crc = crc_word8(t, crc, a.x, a.y);
    crc = crc_word8(t, crc, a.z, a.w);
    crc = crc_word8(t, crc, b.x, b.y);
    crc = crc_word8(t, crc, b.z, b.w);
  }
  for (; len > 0; --len) crc = crc_byte(t, crc, *p++);
  return crc;
}

// consts: the slice-by-8 tables (8x256 words, t[0] the byte table), then
// log_s matrices of 32 column words, level i = M^(seg * 2^i).
__global__ void __launch_bounds__(1 << kCrcMaxLogS)
crc32c_rows_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
                   long long n, long long l, long long seg, int log_s, uint32_t seed,
                   const uint32_t* __restrict__ consts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* mats = tab + kCrcTable;
  uint32_t* partial = mats + 32 * kCrcMaxLogS;   // one register per warp
  for (int i = threadIdx.x; i < kCrcTable + 32 * log_s; i += blockDim.x)
    tab[i] = consts[i];
  __syncthreads();

  const int S = 1 << log_s;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = gid >> log_s;
  const int s = static_cast<int>(gid & (S - 1));
  const long long first = l - static_cast<long long>(S - 1) * seg;
  uint32_t crc = 0;
  if (row < n) {
    const long long start = s == 0 ? 0 : first + (s - 1) * seg;
    crc = crc_span(tab, s == 0 ? seed : 0u, data + row * l + start,
                   s == 0 ? first : seg);
  }

  // fold: at level i, segment s (s % 2^(i+1) == 0) takes s + 2^i's node
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < log_s && i < 5; ++i) {
    const uint32_t right = __shfl_down_sync(0xffffffffu, crc, 1 << i);
    crc = mat_apply(mats + 32 * i, crc) ^ right;
  }
  if (log_s > 5) {   // S / 32 warps a row: fold their registers in the first
    const int warp = threadIdx.x >> 5, wpr = S >> 5;
    if (lane == 0) partial[warp] = crc;
    __syncthreads();
    if (warp % wpr == 0) {
      crc = lane < wpr ? partial[warp + lane] : 0u;
      for (int i = 5; i < log_s; ++i) {
        const uint32_t right = __shfl_down_sync(0xffffffffu, crc, 1 << (i - 5));
        crc = mat_apply(mats + 32 * i, crc) ^ right;
      }
    }
  }
  if (row < n && s == 0) out[row] = crc;
}

}  // namespace

#ifdef __CUDACC__

extern "C" {

// data (n, l) uint8 rows (any alignment), out (n,) uint32; the row splits
// into 2^log_s segments of seg bytes after a first of l - (2^log_s - 1)*seg
// >= 0 bytes; consts as crc32c_rows_kernel reads them (on the device).
int crc32c_chunks(const void* data, void* out, long long n, long long l, long long seg,
                  int log_s, unsigned seed, const void* consts, int device,
                  void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (n < 1 || l < 1 || log_s < 0 || log_s > kCrcMaxLogS || seg < 0 ||
      (log_s > 0 && seg % 16) || l - ((1LL << log_s) - 1) * seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (1 << log_s) > kCrcMinThreads ? (1 << log_s) : kCrcMinThreads;
  const long long blocks = ((n << log_s) + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (kCrcTable + 32 * kCrcMaxLogS + 32) * sizeof(uint32_t);
  crc32c_rows_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(out), n, l, seg, log_s,
      seed, static_cast<const uint32_t*>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#endif  // __CUDACC__
