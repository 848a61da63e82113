// GF(2^8) matrix x stripe bytes as a GF(2) bit-matmul, for Hopper (sm_90a).
//
// Both kernels compute out[b] = M (x) data[b] for an (r,k) GF(2^8)
// coefficient matrix M and a batch of stripes data (B,k,L) uint8, giving
// (B,r,L) uint8, byte-identical to the host oracle gf_matmul.  The product is
// linear over GF(2): with W the (8r,8k) bit matrix of M (row 8i+s = bit s of
// output row i, column 8j+t = bit t of chunk j), output bit (i,s) of byte
// column n is the parity of W[8i+s] & (bits of data[b,0..k-1,n]).
//
// gf2_matmul_popc (K1) replaces ceph_tpu/ops/gf2kernels.py _make_pallas_fn
// (the flat kernel) and _make_pallas_batch_fn (the per-stripe batch kernel).
//   Because of the plane order, the 8k-bit input vector of a byte column is
//   exactly the k bytes data[b,0..k-1,n] laid end to end, so an output bit is
//   popc(Wrow & colbits) & 1 with W rows packed into ceil(k/4) 32-bit words:
//   exactly the single-bit tensor-core product mma.sync m16n8k256 .b1
//   .and.popc, with byte columns as A's 16 rows, 256 contraction bits (32
//   chunks) a k-step, and 8 W rows as B's columns.  On CUDA cores the same
//   function costs a popcount and ceil(k/4) AND/XORs per output bit, which
//   bound the earlier design at 2-11x its HBM bytes; here one MMA does 16
//   columns x 8 output bits x 32 chunks.  What is left around the MMAs:
//   - what holds it is instruction issue around the MMAs (addressing,
//     staging, the parity pack), not the MMAs: at RS k=8,m=3 a byte column
//     needs 1/4 MMA, so a first version that loaded A straight into
//     registers, 64 columns a step, ran at twice the earlier design.  So a
//     grid sized to the card walks (stripe, tile) pairs without a division,
//     a tile is popc_span (up to kPopcMaxSpan) 64-column halves, each warp
//     stages its next tile's k rows into shared memory with cp.async (a ring
//     of kPopcRing), and the A reads are lane constants plus immediates;
//   - A operands from the staged rows: lane (grp, tig) reads one 32-bit
//     word (4 adjacent columns) of chunk rows 4q..4q+3 for q = tig and
//     tig + 4 at columns 4grp and 32 + 4grp of the tile (rows placed so the
//     32 lanes hit 32 banks), and a __byte_perm transpose gives column
//     words; m-tile t's rows grp / grp+8 are columns 4grp+t / 32+4grp+t, so
//     each word is an A register as it stands;
//   - k > 32: every k-step accumulates into the same s32 counts (parity of a
//     sum = sum of parities), so split-k is a loop inside the launch; up to
//     two k-steps (k <= 64) of A stay in registers, more (k > 64) are read
//     from global memory per row group, unstaged;
//   - B fragments in the order the MMA wants, built by the wrapper, copied
//     into shared memory once a block (read from global memory when k > 64,
//     so no k is too large for shared memory);
//   - W rows ordered so that no exchange between lanes is needed: a group of
//     4 output rows is 4 n-tiles, n-tile u column 2p+e = bit 2u+e of row p,
//     so lane tig's accumulators hold all 8 bits of row tig at its columns;
//     bit 0 of each count is gathered with __byte_perm into whole 32-bit
//     words, stored coalesced (each store: 4 rows x 32 bytes).
//   Any L (ragged edge masked; rows that are not 16-byte aligned are staged
//   by an instance with 4-byte cp.async, or byte loads), any k and any batch: one launch takes at most 65535
//   stripes and kPopcMaxRows output rows (a row tile); the wrapper splits
//   the rest (ops/gf2kernels.py popc_stripes, popc_plan).
//
// gf2_matmul_mma (K2) replaces ceph_tpu/ops/gf2kernels.py
// _make_pallas_batch_fn_gN (the packed kernel that put the bit-matmul on the
// TPU's matrix unit: g stripes' plane-major bits against the block-diagonal
// W_gN, contraction 8gk <= 128).
//   It puts the same product on the int8 tensor cores with mma.sync
//   m16n8k32, in the PTX ISA's documented fragment layouts, and takes the
//   same inputs (W_gN tile-major, the grouping g) and shape rules.
//   Bound on the H100: the HBM bytes (0.44 ms for 1 GiB in + 0.375 GiB out
//   at RS k=8,m=3).  What holds it above that is instruction issue: every
//   byte column needs its bit planes built, its products, and its parity
//   bits packed back into bytes.  mma.sync rather than wmma because wmma's
//   fragment layouts are unspecified: its operands must come from memory (8
//   bit-plane copies of every byte written to shared memory and read back)
//   and its accumulators go back through memory to be packed.  The design:
//   - pipelines the loads: each 128-column step's g*k rows are staged by
//     cp.async into a ring of kMmaRing shared buffers, so later steps' bytes
//     are in flight while this step computes; a block's last steps are
//     simply not staged (L % 128 == 0, so every step is whole);
//   - builds the operands in registers, no bit planes in memory: byte
//     columns are the A rows, W's rows the B columns, and the contraction
//     runs in the order s*GP + j (bit s of chunk j), so a lane's A register
//     is one of its column words (a 4x4 byte transpose of four 32-bit loads)
//     shifted by a lane-constant amount and masked;
//   - holds W in registers: its B fragments are permuted to that order once
//     per block (from W_gN's first diagonal block: every stripe is its own
//     product, so no tile is spent on W_gN's zero blocks), two W rows to a
//     B byte (w_a + 128*w_b, u8) while 8k < 128, so one 8-column n-tile
//     makes two output byte rows;
//   - packs with byte permutes and a two-step quad shuffle: each lane ends
//     with one output row's four bytes, stored as a word into the step's
//     output buffer (two, alternating), written out with coalesced 16-byte
//     stores after the next barrier -- one block barrier per step.
//   Requires L % 128 == 0, k <= 16 and 16-byte aligned rows; the Python
//   wrapper routes other shapes to K1.  The batch (B/g stripe groups) is
//   folded into grid.x with the column blocks, so it is not capped at 65535.
//
// Plain C interface for ctypes: each entry launches on the given device and
// stream, allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Without __CUDACC__ the kernels also compile as host C++ (no launchers, no C
// entries): the includer supplies the CUDA built-ins they use and runs each
// block's threads itself, and mma_u8 / mma_b1 call its host_mma_u8 /
// host_mma_b1.  The CPU tests build K1 and K2 that way and hold them against
// the host oracle.

#include <cstddef>
#include <cstdint>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kPopcWarps = 8;         // K1: warps a block
constexpr int kPopcMinBlocks = 2;     // __launch_bounds__: caps registers at 128
constexpr int kPopcRing = 2;          // tiles a warp has staged
constexpr int kPopcMaxSpan = 4;       // 64-column halves of a tile, at most
constexpr int kPopcSmemTarget = 112 * 1024;   // a block's shared memory: two a SM
constexpr int kPopcThreads = 32 * kPopcWarps;
constexpr int kPopcMaxRows = 256;     // output rows a launch: 64 row groups
constexpr int kPopcGroupWords = 4 * 32 * 2;   // B words of a row group and k-step

constexpr int kMmaCols = 128;         // byte columns per step, 32 per warp
constexpr int kMmaWarps = kMmaCols / 32;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRing = 4;           // staged steps (cp.async ring buffers)
constexpr int kMmaSteps = 64;         // steps per block: 8192 columns
constexpr int kMmaMinBlocks = 5;      // __launch_bounds__: caps registers at 96
constexpr int kRawLd = kMmaCols + 16; // staged and output row pitch
constexpr int kRegFrags = 16;         // most W fragments (uint2) in registers
constexpr int kTile = 256;            // bytes of one 16x16 int8 tile
constexpr size_t kMaxSmem = 232448;   // H100: 227 KB a block can use

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDACC__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);   // a host build copies at once
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// 4x4 byte transpose: v[j] holds chunk row j at 4 adjacent columns; col[c]
// gets column c's bytes of the 4 rows, row j at byte j.
__device__ __forceinline__ void transpose4(const uint32_t v[4], uint32_t col[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// Bytes c0..c0+3 of a row, zero past L.  vec: L % 4 == 0 and rows 4-aligned.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, long long c0,
                                          long long L, bool vec) {
  if (vec) return c0 < L ? *reinterpret_cast<const uint32_t*>(row + c0) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < L) v |= static_cast<uint32_t>(row[c0 + c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void store4(uint8_t* row, long long c0, long long L,
                                       bool vec, uint32_t v) {
  if (vec) {
    if (c0 < L) *reinterpret_cast<uint32_t*>(row + c0) = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < L) row[c0 + c] = static_cast<uint8_t>(v >> (8 * c));
}

// 16 bytes from global to shared memory, the first n (0 or 16) read and the
// rest zero-filled, without waiting (commit and wait as cp_async16)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int n) {
#ifdef __CUDACC__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n)
               : "memory");
#else
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, n);
#endif
}

// 4 bytes from global to shared memory, the first n (0 or 4) read and the
// rest zero-filled, without waiting (dst and src 4-byte aligned)
__device__ __forceinline__ void cp_async4z(void* dst, const void* src, int n) {
#ifdef __CUDACC__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(n)
               : "memory");
#else
  std::memset(dst, 0, 4);
  std::memcpy(dst, src, n);
#endif
}

// d += popc(a AND b): a 16x256 bits (row-major), b 256x8 bits (column-
// major), in the PTX fragment layouts for lane = 4*grp + tig: a.x / a.y hold
// rows grp / grp+8 at k = 32tig..32tig+31 (bit = k % 32), a.z / a.w the same
// at k + 128; b.x holds column grp at k = 32tig.., b.y at k + 128; d[0], d[1]
// are row grp at columns 2tig, 2tig+1, d[2], d[3] row grp+8.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint4& a, const uint2& b) {
#ifdef __CUDACC__
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
#else
  host_mma_b1(d, a, b);
#endif
}

// byte t of the result = the low byte of x[t]
__device__ __forceinline__ uint32_t low_bytes(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410);
}

// A staged 64-column half holds chunk row j's 16-byte piece c (columns
// 16c..16c+15) at byte staged(j, c) = 64 * (j ^ bit 2 of j) + 16 * (c ^ 2 *
// bit 3 of j): rows of 64 bytes, placed so that the 32 lanes of one A read
// (rows 4tig + const, words grp of a 32-column half) hit 32 different banks.
// Row slots of a half of k rows:
__host__ __device__ constexpr int popc_rows(int k) { return (k + 1) & ~1; }

// One K1 launch: output rows i0..i0+rg-1 of B stripes, over all k chunks.
// wfrag holds W's B fragments for those rows (the wrapper's
// popc_fragments): per row group g4 (rows 4g4..4g4+3 of the tile), k-step ks
// and n-tile u, 32 lanes x (b.x, b.y), at uint2 index ((g4*nks + ks)*4 + u)*32
// + lane; n-tile u's column 2p+e is bit 2u+e of row 4g4+p, and lane (grp, tig)
// holds that row's W words 8ks+tig and 8ks+tig+4 (chunks 4q..4q+3 a word).
// The grid is sized to the card; each warp walks tiles of SPAN 64-column
// halves (stripe b, columns c*64*SPAN..) at a stride of the grid's warps.
// KS > 0: the launch has KS = ceil(k/32) k-steps; W is copied into shared
// memory, each warp stages its next tiles' k rows into a ring of kPopcRing
// (kAsync16, for L % 16 == 0 and 16-byte aligned data: 16-byte cp.async;
// else 4-byte cp.async when vec, byte loads otherwise), and A stays in
// registers for the row groups; kHalfLast: the last k-step's chunks 16..31
// are past k, so their A words are 0.  KS = 0: any number of k-steps, no
// staging: A is loaded from global memory per row group (L1 hits) and W
// read from global memory.
template <int KS, bool kHalfLast, int SPAN, bool kAsync16>
__global__ void __launch_bounds__(kPopcThreads, kPopcMinBlocks)
gf2_popc_kernel(const uint2* __restrict__ wfrag, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int B, int k, int r, int i0, int rg,
                long long L, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nks = KS ? KS : (k + 31) / 32;
  const int ngroups = (rg + 3) / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int half_bytes = 64 * popc_rows(k);   // a staged 64-column half
  const int stage_bytes = SPAN * half_bytes;
  const uint2* wf = wfrag;
  unsigned char* ring = smem;
  if constexpr (KS > 0) {
    const int w_words = ngroups * KS * kPopcGroupWords;
    uint4* w_s = reinterpret_cast<uint4*>(smem);
    const uint4* w_g = reinterpret_cast<const uint4*>(wfrag);
    for (int e = threadIdx.x; e < w_words / 4; e += blockDim.x) w_s[e] = w_g[e];
    __syncthreads();
    wf = reinterpret_cast<const uint2*>(smem);
    ring = smem + w_words * sizeof(uint32_t) + warp * kPopcRing * stage_bytes;
  }

  // this warp's tiles of 64*SPAN columns: (stripe b, tile c) of every
  // nwarps-th tile, walked without a division per tile (the entry keeps the
  // tiles of a stripe and the grid's warps under 2^31)
  constexpr long long tile_cols = 64LL * SPAN;
  const int ntl = static_cast<int>((L + tile_cols - 1) / tile_cols);
  const int nwarps = gridDim.x * kPopcWarps;
  const int first = blockIdx.x * kPopcWarps + warp;
  const int step_b = nwarps / ntl, step_c = nwarps - step_b * ntl;
  int at_b = first / ntl, at_c = first - at_b * ntl;   // the tile computed next
  int ahead_b = at_b, ahead_c = at_c;                  // the tile staged next
  const long long kL = static_cast<long long>(k) * L;

  // staging: lane copies piece sc (16 bytes) of rows sj + 8n, n < nrow, to
  // staged(sj + 8n, sc) = d_even / d_odd (n even / odd) + 512n
  const int sj = lane >> 2, sc = lane & 3;
  const int nrow = k > sj ? (k - sj + 7) >> 3 : 0;
  const int d_even = 64 * (sj ^ ((sj >> 2) & 1)) + 16 * sc;
  const int d_odd = d_even + 16 * ((sc ^ 2) - sc);
  const uint8_t* s_lane = data + sj * L + 16 * sc;
  // tile `ahead` -> ring slot `slot`, one commit group per call
  auto stage = [&](int slot) {
    if (ahead_b < B) {
      const long long base = ahead_c * tile_cols;
      const uint8_t* s0 = s_lane + ahead_b * kL + base;
      unsigned char* d0 = ring + slot * stage_bytes;
#pragma unroll
      for (int half = 0; half < SPAN; ++half) {
        const long long rest = L - base - 16 * sc - 64 * half;   // of the piece's row
        const uint8_t* src = s0 + 64 * half;
        unsigned char* d = d0 + half * half_bytes;
        for (int n = 0; n < nrow; ++n, src += 8 * L, d += 512) {
          unsigned char* dst = d + ((n & 1) ? d_odd : d_even);
          if constexpr (kAsync16) {
            cp_async16z(dst, src, rest > 0 ? 16 : 0);
          } else if (vec) {
#pragma unroll
            for (int w = 0; w < 4; ++w) cp_async4z(dst + 4 * w, src + 4 * w, rest > 4 * w ? 4 : 0);
          } else {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              reinterpret_cast<uint32_t*>(dst)[w] = load4(src, 4 * w, rest, false);
          }
        }
      }
      ahead_b += step_b;
      ahead_c += step_c;
      if (ahead_c >= ntl) {
        ahead_c -= ntl;
        ++ahead_b;
      }
    }
    cp_async_commit();
  };
  if constexpr (KS > 0)
    for (int i = 0; i < kPopcRing - 1; ++i) stage(i);

  // A reads from a staged half: row 32ks + 16h2 + 4tig + jj, word grp of
  // column half h is at staged(row, 2h + grp/4) + 4(grp%4) =
  // a_off[jj%2][h] + 64(jj & 2) + 1024h2 + 2048ks (rows past k hold stale
  // bytes: W's bits for them are 0)
  const int t1 = tig & 1, t2 = tig >> 1;
  int a_off[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a_off[p][h] = 256 * tig + 64 * (p ^ t1) + 32 * (h ^ t2) + 16 * (grp >> 2) + 4 * (grp & 3);
  // this lane's output row tig of a row group, at columns 4grp (+32)
  const long long o_lane = tig * L + 4 * grp;

  for (int i = 0; at_b < B; ++i) {   // uniform in the warp
    if constexpr (KS > 0) {
      stage((i + kPopcRing - 1) % kPopcRing);   // the slot tile i-1 was read from
      cp_async_wait<kPopcRing - 1>();
      __syncwarp();                             // tile i's rows, from every lane, are in
    }
    const uint8_t* src_b = data + at_b * kL;
    uint8_t* out_b = out + (static_cast<long long>(at_b) * r + i0) * L + o_lane;
#pragma unroll
    for (int half = 0; half < SPAN; ++half) {
      const long long base = at_c * tile_cols + 64 * half;
      if (base >= L) break;   // uniform in the warp
      const bool full = vec && base + 64 <= L;
      const unsigned char* st = ring + (i % kPopcRing) * stage_bytes + half * half_bytes;
      // A of k-step ks, m-tiles t = 0..3: chunk rows 32ks + 4tig + 16h2 + jj
      // at columns 32h + 4grp .. +3 of the half, transposed into column words
      auto load_a = [&](int ks, uint4 (&at4)[4]) {
        uint32_t cw[2][2][4];   // [column half h][word half h2][column t]
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (kHalfLast && ks == KS - 1 && h2 == 1) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int t = 0; t < 4; ++t) cw[h][h2][t] = 0u;
            continue;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if constexpr (KS > 0) {
                v[jj] = *reinterpret_cast<const uint32_t*>(
                    st + a_off[jj & 1][h] + 64 * (jj & 2) + 1024 * h2 + 2048 * ks);
              } else {
                const int j = 32 * ks + 4 * tig + 16 * h2 + jj;
                v[jj] = j < k ? load4(src_b + j * L + base, 32 * h + 4 * grp, L - base, vec)
                              : 0u;
              }
            }
            transpose4(v, cw[h][h2]);
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
          at4[t] = make_uint4(cw[0][0][t], cw[1][0][t], cw[0][1][t], cw[1][1][t]);
      };
      uint4 a[KS ? KS : 1][4];
      if constexpr (KS > 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) load_a(ks, a[ks]);
      }
      uint8_t* po = out_b + base;
      const long long rest = L - base - 4 * grp;
      for (int g4 = 0; g4 < ngroups; ++g4, po += 4 * L) {
        int acc[4][4][4] = {};   // [m-tile t][n-tile u][fragment]
#pragma unroll(KS ? KS : 1)
        for (int ks = 0; ks < nks; ++ks) {
          if constexpr (KS == 0) load_a(ks, a[0]);
          const uint4 (&ak)[4] = a[KS ? ks : 0];
          const uint2* w = wf + (g4 * nks + ks) * 4 * 32 + lane;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint2 bu = w[u * 32];
#pragma unroll
            for (int t = 0; t < 4; ++t) mma_b1(acc[t][u], ak[t], bu);
          }
        }
        // this lane's row 4g4+tig: byte t of the word at columns 32h + 4grp
        // is column 4grp+t of half h, bit 2u+e from acc[t][u][2h+e]
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = 2 * h + e;
              word[h] |= (low_bytes(acc[0][u][f], acc[1][u][f], acc[2][u][f], acc[3][u][f]) &
                          0x01010101u) << (2 * u + e);
            }
        if (4 * g4 + tig < rg) {
          if (full) {
            *reinterpret_cast<uint32_t*>(po) = word[0];
            *reinterpret_cast<uint32_t*>(po + 32) = word[1];
          } else {
            store4(po, 0, rest, vec, word[0]);
            store4(po + 32, 0, rest - 32, vec, word[1]);
          }
        }
      }
    }
    if constexpr (KS > 0) __syncwarp();   // tile i's slot is read out
    at_b += step_b;
    at_c += step_c;
    if (at_c >= ntl) {
      at_c -= ntl;
      ++at_b;
    }
  }
}

using PopcKernel = void (*)(const uint2*, const uint8_t*, uint8_t*, int, int, int, int, int,
                            long long, bool);

// k-steps of 32 chunks for k chunks
constexpr int popc_ksteps(int k) { return (k + 31) / 32; }

// k-steps held in registers: all of them up to two (k <= 64), else 0
constexpr int popc_reg_steps(int k) {
  return popc_ksteps(k) <= 2 ? popc_ksteps(k) : 0;
}

// bytes of W's fragments in shared memory (when A stays in registers)
constexpr size_t popc_w_bytes(int k, int rg) {
  return static_cast<size_t>(popc_reg_steps(k)) * ((rg + 3) / 4) * kPopcGroupWords *
         sizeof(uint32_t);
}

// 64-column halves a tile takes: kPopcMaxSpan, or half of it, as long as a
// block's shared memory stays within kPopcSmemTarget, else 1 (and 1 without
// staging)
constexpr int popc_span(int k, int rg) {
  auto fits = [&](int span) {
    return popc_w_bytes(k, rg) + static_cast<size_t>(kPopcWarps) * kPopcRing * span * 64 *
                                     popc_rows(k) <= kPopcSmemTarget;
  };
  return popc_reg_steps(k) == 0 ? 1
         : fits(kPopcMaxSpan)   ? kPopcMaxSpan
         : fits(kPopcMaxSpan / 2) && kPopcMaxSpan > 1 ? kPopcMaxSpan / 2
                                                       : 1;
}

// shared memory of a launch when A stays in registers: W's fragments, then
// each warp's ring of staged tiles (popc_span halves of popc_rows(k) rows of
// 64 bytes), then room for the last half's A reads of rows up to 32*KS
constexpr size_t popc_smem_bytes(int k, int rg) {
  return popc_reg_steps(k) == 0
             ? 0
             : popc_w_bytes(k, rg) +
                   static_cast<size_t>(kPopcWarps) * kPopcRing * popc_span(k, rg) * 64 *
                       popc_rows(k) +
                   64 * (32 * popc_reg_steps(k) - popc_rows(k));
}

// K1 with KS k-steps in registers; kHalfLast when the last k-step has at
// most 16 of its 32 chunks.  The staging is a template (kAsync16) so that
// the 16-byte aligned instances carry no other load path (timed in turns on
// an H100 with tools/k1_time.py: a runtime branch cost RS encode 2-3%).
template <int KS, int SPAN, bool kAsync16>
PopcKernel popc_instance(int k) {
  return k - 32 * (KS - 1) <= 16 ? gf2_popc_kernel<KS, true, SPAN, kAsync16>
                                 : gf2_popc_kernel<KS, false, SPAN, kAsync16>;
}

template <int KS, int SPAN>
PopcKernel popc_instance(int k, bool async16) {
  return async16 ? popc_instance<KS, SPAN, true>(k) : popc_instance<KS, SPAN, false>(k);
}

template <int KS>
PopcKernel popc_instance(int k, int span, bool async16) {
  static_assert(kPopcMaxSpan == 1 || kPopcMaxSpan == 2 || kPopcMaxSpan == 4 ||
                kPopcMaxSpan == 8 || kPopcMaxSpan == 16);
  return span >= kPopcMaxSpan     ? popc_instance<KS, kPopcMaxSpan>(k, async16)
         : span >= kPopcMaxSpan / 2 ? popc_instance<KS, (kPopcMaxSpan > 1 ? kPopcMaxSpan / 2 : 1)>(k, async16)
                                    : popc_instance<KS, 1>(k, async16);
}

// The K1 instance for k chunks and row tiles of rg rows (popc_span halves a
// tile: kPopcMaxSpan, half of it, or 1); async16: rows 16-byte aligned.
PopcKernel popc_kernel_for(int k, int rg, bool async16) {
  const int span = popc_span(k, rg);
  switch (popc_reg_steps(k)) {
    case 1: return popc_instance<1>(k, span, async16);
    case 2: return popc_instance<2>(k, span, async16);
    default: return gf2_popc_kernel<0, false, 1, false>;
  }
}

// Shared memory of one K2 block, in this order (every part 16-byte aligned):
// W's B fragments in mma order when they are not held in registers, NT*KS*32
// lanes x 8 bytes; the ring of kMmaRing staged steps, g*k rows of kRawLd
// bytes; two output buffers of g*r rows of kRawLd bytes, one filled while
// the other is stored.
constexpr size_t mma_smem_bytes(bool reg_w, int NT, int KS, int r, int g, int k) {
  return (reg_w ? 0 : static_cast<size_t>(NT) * KS * 32 * 8) +
         static_cast<size_t>(kMmaRing) * g * k * kRawLd +
         static_cast<size_t>(2) * g * r * kRawLd;
}

// d += a (16x32 u8, row-major) x b (32x8 u8, column-major), in the PTX
// fragment layouts for lane = 4*grp + tig: a.x / a.y hold rows grp / grp+8 at
// k = 4tig..4tig+3 (byte = k % 4), a.z / a.w the same at k + 16; b.x holds
// column grp at k = 4tig..4tig+3, b.y at k + 16; d[0], d[1] are row grp at
// columns 2tig, 2tig+1, d[2], d[3] row grp+8.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, const uint2& b) {
#ifdef __CUDACC__
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
#else
  host_mma_u8(d, a, b);
#endif
}

// GP = k rounded up to 4, 8 or 16.  Each stripe is its own product,
// bits(byte columns x 8*GP) x W^T(8*GP x 8r): byte columns are the mma's
// rows (A), W's rows the columns (B), so no tile is spent on the other
// stripes' zero blocks of W_gN.  kPair (k <= 15): a B byte carries two W
// rows, w_a + 128*w_b, so an 8-column n-tile makes output byte rows 2nt and
// 2nt+1: with at most 8k <= 120 terms, bit 0 of the count is row a's parity
// and bit 7 row b's.  Otherwise an n-tile is one byte row.
// The contraction runs in the kernel's own order, index s*GP + j = bit s of
// chunk j (chunks j >= k are zero), in KS = GP/4 k-steps of 32: a lane's A
// register is then one of its column words shifted by a lane-constant
// amount and masked.  W's columns are permuted to match once per block, from
// W_gN's first diagonal block (its g blocks are equal).  kRegW: the NT*KS B
// fragments (2 registers each) live in registers, at constant indices.
// wt: W_gN zero-padded to (16*MT, 16*KT), tile-major (MT, KT, 16, 16).
template <int GP, bool kPair, bool kRegW>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
gf2_mma_kernel(const int8_t* __restrict__ wt, const uint8_t* __restrict__ data,
               uint8_t* __restrict__ out, int k, int r, int g, long long L) {
  constexpr int KS = GP / 4;
  constexpr int NP = kPair ? 2 : 1;        // output byte rows per n-tile
  constexpr int kNReg = kRegW ? kRegFrags / KS : 1;
  constexpr int kVecs = kMmaCols / 16;   // 16-byte pieces of a step's row

  extern __shared__ __align__(16) unsigned char smem[];
  const int gk = g * k, gr = g * r, KT = (gk + 1) / 2;
  uint2* bfrag = reinterpret_cast<uint2*>(smem);
  const int NT = (r + NP - 1) / NP;        // n-tiles
  unsigned char* ring = smem + (kRegW ? 0 : static_cast<size_t>(NT) * KS * 32 * 8);
  unsigned char* out_s = ring + kMmaRing * gk * kRawLd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  // grid.x = (stripe group, column block) pairs, column blocks fastest
  const long long per_block = static_cast<long long>(kMmaCols) * kMmaSteps;
  const long long ncb = (L + per_block - 1) / per_block;
  const long long sg = blockIdx.x / ncb;
  const long long b0 = sg * g;
  const uint8_t* src = data + b0 * k * L;   // g stripes = g*k consecutive rows
  const long long col_begin = (blockIdx.x - sg * ncb) * per_block;
  const int nsteps = static_cast<int>(
      (min(L, col_begin + kMmaCols * kMmaSteps) - col_begin) / kMmaCols);

  // step t's g*k rows -> ring slot t % kMmaRing, one commit group per call
  // (empty past the block's last step, so the ring's waits stay uniform)
  auto stage = [&](int t) {
    if (t < nsteps) {
      unsigned char* dst = ring + (t % kMmaRing) * gk * kRawLd;
      const uint8_t* s = src + col_begin + static_cast<long long>(t) * kMmaCols;
      for (int e = tid; e < gk * kVecs; e += kMmaThreads) {
        const int j = e / kVecs, c = e - j * kVecs;
        cp_async16(dst + j * kRawLd + c * 16, s + j * L + c * 16);
      }
    }
    cp_async_commit();
  };
  // step t's output bytes (buffer t % 2) -> out, 16 bytes a thread
  auto store = [&](int t) {
    const unsigned char* ob = out_s + (t & 1) * gr * kRawLd;
    const long long c0 = col_begin + static_cast<long long>(t) * kMmaCols;
    for (int e = tid; e < gr * kVecs; e += kMmaThreads) {
      const int q = e / kVecs, c = e - q * kVecs;   // q = stripe * r + i
      *reinterpret_cast<uint4*>(out + (b0 * r + q) * L + c0 + c * 16) =
          *reinterpret_cast<const uint4*>(ob + q * kRawLd + c * 16);
    }
  };
  // W's B fragment for n-tile nt and k-step kk, as lane ln holds it
  auto w_frag = [&](int nt, int kk, int ln) {
    const int row = 8 * NP * nt + (ln >> 2);   // row a; row b is 8 further
    const bool has_b = kPair && NP * nt + 1 < r;
    auto w = [&](int rw, int c) {
      return static_cast<uint32_t>(static_cast<uint8_t>(
          wt[((rw >> 4) * KT + (c >> 4)) * kTile + (rw & 15) * 16 + (c & 15)]));
    };
    uint32_t v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int K = 32 * kk + 16 * h + 4 * (ln & 3) + jj;
        const int s = K / GP, j = K - s * GP;
        if (j < k) {
          const int c = s * gk + j;   // W_gN's column: plane-major
          const uint32_t b = w(row, c) | (has_b ? w(row + 8, c) << 7 : 0u);
          word |= b << (8 * jj);
        }
      }
      v[h] = word;
    }
    return make_uint2(v[0], v[1]);
  };

  for (int t = 0; t < kMmaRing - 1; ++t) stage(t);
  uint2 bf[kNReg][KS];
  if constexpr (kRegW) {
#pragma unroll
    for (int nt = 0; nt < kNReg; ++nt)
      if (nt < NT)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) bf[nt][kk] = w_frag(nt, kk, lane);
  } else {
    for (int e = tid; e < NT * KS * 32; e += kMmaThreads) {
      const int nk = e >> 5, nt = nk / KS;
      bfrag[e] = w_frag(nt, nk - nt * KS, e & 31);
    }
  }
  // the lane's chunk rows 4q..4q+3 and its plane offset: a.x of k-step kk
  // is bit 32kk/GP + s_lane of those rows, a.z bit 16/GP further
  const int q = tig % (GP / 4), s_lane = tig / (GP / 4);

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<kMmaRing - 2>();
    __syncthreads();   // step t staged (and W's fragments); step t-1 done
    if (t > 0) store(t - 1);
    stage(t + kMmaRing - 1);   // into the slot step t-1 was read from

    const unsigned char* st = ring + (t % kMmaRing) * gk * kRawLd + warp * 32 + 4 * grp;
    unsigned char* ob = out_s + (t & 1) * gr * kRawLd + warp * 32 + 4 * grp;
    auto stripe_out = [&](int stripe) {
      // the warp's 32 columns: chunk rows 4q..4q+3 at columns 4grp..4grp+3,
      // transposed so cw[i] is column 4grp+i (row 4q+jj at byte jj); that
      // column is row grp + 8(i/2) of m-tile i%2
      const unsigned char* sr = st + stripe * k * kRawLd;
      uint32_t v[4], cw[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = 4 * q + jj < k
                    ? *reinterpret_cast<const uint32_t*>(sr + (4 * q + jj) * kRawLd)
                    : 0u;
      transpose4(v, cw);
      uint4 a[2][KS];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int s0 = 32 * kk / GP + s_lane, s1 = s0 + 16 / GP;
          a[m][kk] = make_uint4((cw[m] >> s0) & 0x01010101u, (cw[m + 2] >> s0) & 0x01010101u,
                                (cw[m] >> s1) & 0x01010101u, (cw[m + 2] >> s1) & 0x01010101u);
        }
      // one n-tile: 2 m-tiles x KS mma; this lane's bits 2tig, 2tig+1 of
      // the bytes at columns 4grp..4grp+3 (byte i = column 4grp+i) of its
      // output byte rows (.x: row a, .y: row b)
      auto partial = [&](const uint2 (&b)[KS]) {
        int acc[2][4] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) mma_u8(acc[m], a[m][kk], b[kk]);
        const uint32_t even = __byte_perm(__byte_perm(acc[0][0], acc[1][0], 0x0040),
                                          __byte_perm(acc[0][2], acc[1][2], 0x0040), 0x5410);
        const uint32_t odd = __byte_perm(__byte_perm(acc[0][1], acc[1][1], 0x0040),
                                         __byte_perm(acc[0][3], acc[1][3], 0x0040), 0x5410);
        const uint32_t row_a = (even & 0x01010101u) | ((odd << 1) & 0x02020202u);
        const uint32_t row_b = ((even >> 7) & 0x01010101u) | ((odd >> 6) & 0x02020202u);
        return make_uint2(row_a << (2 * tig), kPair ? row_b << (2 * tig) : 0u);
      };
      // rows n4..n4+3: OR the quad's partial words so lane tig ends with row
      // n4+tig complete (two exchange steps), and store it
      auto rows_out = [&](int n4, uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
        const bool odd = tig & 1, high = tig & 2;
        uint32_t ka = odd ? w1 : w0, kb = odd ? w3 : w2;
        ka |= __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 1);
        kb |= __shfl_xor_sync(0xffffffffu, odd ? w2 : w3, 1);
        const uint32_t word =
            (high ? kb : ka) | __shfl_xor_sync(0xffffffffu, high ? ka : kb, 2);
        if (n4 + tig < r)
          *reinterpret_cast<uint32_t*>(ob + (stripe * r + n4 + tig) * kRawLd) = word;
      };
      // the partial words of rows n4..n4+3 (n-tiles n4/NP..), then rows_out;
      // with kRegW, n4 is a compile-time constant wherever this is called
      auto rows4 = [&](int n4) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; i += NP)
          if (n4 + i < r) {
            const int nt = (n4 + i) / NP;
            uint2 b[KS];
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              if constexpr (kRegW) b[kk] = bf[nt][kk];
              else b[kk] = bfrag[(nt * KS + kk) * 32 + lane];
            }
            const uint2 p = partial(b);
            w[i] = p.x;
            if constexpr (kPair) w[i + 1] = p.y;
          }
        rows_out(n4, w[0], w[1], w[2], w[3]);
      };
      if constexpr (kRegW) {
#pragma unroll
        for (int n4 = 0; n4 < kNReg * NP; n4 += 4)
          if (n4 < r) rows4(n4);
      } else {
        for (int n4 = 0; n4 < r; n4 += 4) rows4(n4);
      }
    };
    for (int stripe = 0; stripe < g; ++stripe) stripe_out(stripe);
  }
  __syncthreads();   // the last step's output bytes are complete
  if (nsteps > 0) store(nsteps - 1);
}

using MmaKernel = void (*)(const int8_t*, const uint8_t*, uint8_t*, int, int, int,
                           long long);

// k-steps of 32 of the kernel's contraction for k chunks
constexpr int mma_ksteps(int k) { return k <= 4 ? 1 : k <= 8 ? 2 : 4; }

// n-tiles of r output byte rows: two rows a tile while 8k < 128
constexpr int mma_ntiles(int k, int r) { return k <= 15 ? (r + 1) / 2 : r; }

// whether W's B fragments are held in registers
constexpr bool mma_reg_w(int k, int r) {
  return mma_ntiles(k, r) <= kRegFrags / mma_ksteps(k);
}

template <int GP, bool kPair>
MmaKernel mma_kernel(int k, int r) {
  return mma_reg_w(k, r) ? gf2_mma_kernel<GP, kPair, true> : gf2_mma_kernel<GP, kPair, false>;
}

// The K2 instance for k chunks and r output rows per stripe.
MmaKernel mma_kernel_for(int k, int r) {
  return k <= 4    ? mma_kernel<4, true>(k, r)
         : k <= 8  ? mma_kernel<8, true>(k, r)
         : k <= 15 ? mma_kernel<16, true>(k, r)
                   : mma_kernel<16, false>(k, r);
}

#ifdef __CUDACC__

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

extern "C" {

// One K1 launch (see gf2_popc_kernel): data (B,k,L) uint8, out (B,r,L),
// B <= 65535; wfrag W's B fragments for output rows i0..i0+rg-1,
// rg <= kPopcMaxRows: ceil(rg/4) * ceil(k/32) * kPopcGroupWords uint32,
// 16-byte aligned.  The grid: the card's SMs x resident blocks, or fewer
// when there are fewer tiles.
int gf2_matmul_popc(const void* wfrag, const void* data, void* out, int B, int k, int r,
                    int i0, int rg, long long L, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (B < 1 || B > 65535 || k < 1 || r < 1 || rg < 1 || rg > kPopcMaxRows || i0 < 0 ||
      i0 + rg > r || L < 1 || reinterpret_cast<uintptr_t>(wfrag) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool async16 = L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  const PopcKernel kernel = popc_kernel_for(k, rg, async16);
  const size_t smem = popc_smem_bytes(k, rg);
  cudaError_t err = prepare_smem(kernel, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPopcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int span = popc_span(k, rg);
  const long long ntl = (L + 64LL * span - 1) / (64LL * span);
  const long long want = (B * ntl + kPopcWarps - 1) / kPopcWarps;
  const long long full = static_cast<long long>(sms) * per_sm;
  if (ntl > 0x7fffffffLL || full * kPopcWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  kernel<<<static_cast<unsigned>(want < full ? want : full), kPopcThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(wfrag), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), B, k, r, i0, rg, L, vec);
  return static_cast<int>(cudaGetLastError());
}

// The K1 instance gf2_matmul_popc launches for k chunks, a row tile of rg
// rows and 16-byte aligned rows: info[0] registers per thread, info[1] shared memory per block
// (dynamic + static), info[2] resident blocks per SM, info[3] local memory
// per thread in bytes.
int gf2_popc_config(int k, int rg, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || rg < 1 || rg > kPopcMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const PopcKernel kernel = popc_kernel_for(k, rg, true);
  const size_t smem = popc_smem_bytes(k, rg);
  cudaFuncAttributes attr;
  if ((err = prepare_smem(kernel, smem)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                           kPopcThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// wt: W_gN padded and tile-major, (ceil(g*r/2), ceil(g*k/2), 16, 16) int8;
// data (B,k,L) uint8 with L % 128 == 0; out (B,r,L); data and out 16-byte
// aligned.
int gf2_matmul_mma(const void* wt, const void* data, void* out, int B, int k,
                   int r, int g, long long L, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const long long per_block = static_cast<long long>(kMmaCols) * kMmaSteps;
  if (g < 1 || B < g || B % g || k < 1 || 8 * g * k > 128 || r < 1 || L < 1 ||
      L % kMmaCols || reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      static_cast<long long>(B / g) * ((L + per_block - 1) / per_block) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaKernel kernel = mma_kernel_for(k, r);
  const size_t smem = mma_smem_bytes(mma_reg_w(k, r), mma_ntiles(k, r), mma_ksteps(k), r, g, k);
  const cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B / g) *
                                        ((L + per_block - 1) / per_block)));
  kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wt), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), k, r, g, L);
  return static_cast<int>(cudaGetLastError());
}

// The K2 instance gf2_matmul_mma launches for (k, r, g): info[0] registers
// per thread, info[1] shared memory per block (dynamic + static), info[2]
// resident blocks per SM, info[3] local memory per thread in bytes.
int gf2_mma_config(int k, int r, int g, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g < 1 || k < 1 || 8 * g * k > 128 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaKernel kernel = mma_kernel_for(k, r);
  const size_t smem = mma_smem_bytes(mma_reg_w(k, r), mma_ntiles(k, r), mma_ksteps(k), r, g, k);
  cudaFuncAttributes attr;
  if ((err = prepare_smem(kernel, smem)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                           kMmaThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
