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
//   popc(Wrow & colbits) & 1 with W rows packed into ceil(k/4) 32-bit words.
//   Bound on the H100: integer issue, not memory -- 8r popcounts plus 2*8r*
//   ceil(k/4) AND/XOR per byte column (24 popc per column at k=8,m=3) against
//   16 popc per clock per SM.  The design keeps everything else cheap: one
//   coalesced 32-bit load per chunk row and thread (4 adjacent columns), a
//   __byte_perm transpose into column words, W rows in shared memory read as
//   broadcasts, one 32-bit store per output row.  Any L (ragged edge masked),
//   any batch and any k: one launch takes at most 65535 stripes (grid.y),
//   contracts over a group of at most 32 chunks and writes up to
//   kPopcMaxRows output rows (a W tile that fits shared memory); the wrapper
//   splits a larger product into such launches (ops/gf2kernels.py
//   popc_stripes, popc_plan), a row tile's launches after its first XORing
//   their partial products into the output (``acc``): GF(2) is linear, so
//   split-k is exact.
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
// block's threads itself, and mma_u8 calls its host_mma_u8.  The CPU tests
// build K2 that way and hold it against the host oracle.

#include <cstddef>
#include <cstdint>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kPopcThreads = 256;
constexpr int kPopcCols = 4;          // adjacent byte columns per thread
constexpr int kPopcMaxNQ = 8;         // W words per row and launch: 32 chunks
constexpr int kPopcMaxRows = 512;     // output rows per launch (W tile <= 128 KB)

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
  if (vec) return *reinterpret_cast<const uint32_t*>(row + c0);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < L) v |= static_cast<uint32_t>(row[c0 + c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void store4(uint8_t* row, long long c0, long long L,
                                       bool vec, uint32_t v) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(row + c0) = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c0 + c < L) row[c0 + c] = static_cast<uint8_t>(v >> (8 * c));
}

// One K1 launch: output rows i0..i0+rg-1 of every stripe over chunks
// j0..j0+kg-1 (kg <= 4*NQ).  wpk is that tile of W, (8*rg, NQ) words: word q
// of row 8i+s holds W bits of chunks j0+4q..j0+4q+3.  With kAcc the partial
// product is XORed into the output instead of stored.  grid.x covers the
// columns, grid.y the stripes (at most 65535: the wrapper splits a larger
// batch into launches on offset base pointers).
template <int NQ, bool kAcc>
__global__ void __launch_bounds__(kPopcThreads)
gf2_popc_kernel(const uint32_t* __restrict__ wpk, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int k, int j0, int kg, int r, int i0, int rg,
                long long L, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 8 * rg * NQ; i += blockDim.x) w_s[i] = wpk[i];
  __syncthreads();

  const long long b = blockIdx.y;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kPopcCols;
  if (c0 >= L) return;

  const uint8_t* src = data + (b * k + j0) * L;
  uint32_t col[kPopcCols][NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    uint32_t v[4], t[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj;
      v[jj] = j < kg ? load4(src + j * L, c0, L, vec) : 0u;
    }
    transpose4(v, t);
#pragma unroll
    for (int c = 0; c < kPopcCols; ++c) col[c][q] = t[c];
  }

  uint8_t* dst = out + (b * r + i0) * L;
  for (int i = 0; i < rg; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t* w = w_s + (8 * i + s) * NQ;
#pragma unroll
      for (int c = 0; c < kPopcCols; ++c) {
        uint32_t acc = 0;
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc ^= w[q] & col[c][q];
        word |= static_cast<uint32_t>(__popc(acc) & 1) << (8 * c + s);
      }
    }
    if constexpr (kAcc) word ^= load4(dst + i * L, c0, L, vec);
    store4(dst + i * L, c0, L, vec, word);
  }
}

using PopcKernel = void (*)(const uint32_t*, const uint8_t*, uint8_t*, int, int, int,
                            int, int, int, long long, bool);

template <bool kAcc>
PopcKernel popc_kernel_nq(int kg) {
  switch ((kg + 3) / 4) {
    case 1: return gf2_popc_kernel<1, kAcc>;
    case 2: return gf2_popc_kernel<2, kAcc>;
    case 3: return gf2_popc_kernel<3, kAcc>;
    case 4: return gf2_popc_kernel<4, kAcc>;
    case 5: return gf2_popc_kernel<5, kAcc>;
    case 6: return gf2_popc_kernel<6, kAcc>;
    case 7: return gf2_popc_kernel<7, kAcc>;
    default: return gf2_popc_kernel<8, kAcc>;
  }
}

// The K1 instance for a group of kg <= 32 chunks (NQ = ceil(kg/4)) that
// stores (a row tile's first launch) or XORs into the output (acc).
PopcKernel popc_kernel_for(int kg, bool acc) {
  return acc ? popc_kernel_nq<true>(kg) : popc_kernel_nq<false>(kg);
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
// B <= 65535; wpk the (8*rg, ceil(kg/4)) uint32 W tile of output rows i0..
// over chunks j0..j0+kg-1, kg <= 32, rg <= kPopcMaxRows; acc XORs into out.
int gf2_matmul_popc(const void* wpk, const void* data, void* out, int B, int k, int j0,
                    int kg, int r, int i0, int rg, long long L, int acc, int device,
                    void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (B < 1 || B > 65535 || k < 1 || kg < 1 || kg > 4 * kPopcMaxNQ || j0 < 0 ||
      j0 + kg > k || r < 1 || rg < 1 || rg > kPopcMaxRows || i0 < 0 || i0 + rg > r ||
      L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PopcKernel kernel = popc_kernel_for(kg, acc != 0);
  const size_t smem = static_cast<size_t>(8) * rg * ((kg + 3) / 4) * sizeof(uint32_t);
  const cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kPopcThreads) * kPopcCols;
  const long long ncb = (L + per_block - 1) / per_block;
  if (ncb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ncb), static_cast<unsigned>(B));
  const bool vec = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  kernel<<<grid, kPopcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wpk), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), k, j0, kg, r, i0, rg, L, vec);
  return static_cast<int>(cudaGetLastError());
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
