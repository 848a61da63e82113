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
//   broadcasts, one 32-bit store per output row.  Any L (ragged edge masked)
//   and any k <= 32.
//
// gf2_matmul_mma (K2) replaces ceph_tpu/ops/gf2kernels.py
// _make_pallas_batch_fn_gN (the packed kernel that put the bit-matmul on the
// TPU's matrix unit).
//   It puts the same product on the int8 tensor cores: g stripes x 128 byte
//   columns are unpacked plane-major (row s*g*k + j = bit s of chunk j) into
//   0/1 int8 in shared memory, multiplied by the block-diagonal W_gN with
//   wmma 16x16x16 int8 -> int32, then &1 and 8 bit rows packed per byte.
//   Bound on the H100: the HBM bytes (0.44 ms for 1 GiB in + 0.375 GiB out).
//   This first version is far from it: every 128-column step of a block
//   loads its bytes, writes them as 8x as many bit-plane bytes to shared
//   memory, and packs each 16x16 accumulator tile through shared memory,
//   with two block barriers and no overlap of the next load with the
//   current step's work.  W's rows and contraction are zero-padded to
//   multiples of 16 so decode (r=2), odd k and g=1 at k=10 (contraction 80)
//   take the same path.  Requires L % 128 == 0 and 16-byte aligned rows;
//   the Python wrapper routes other shapes to K1.
//
// Plain C interface for ctypes: each entry launches on the given device and
// stream, allocates nothing, and returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kPopcThreads = 256;
constexpr int kPopcCols = 4;          // adjacent byte columns per thread

constexpr int kMmaThreads = 256;      // 8 warps, one 16-column n-tile each
constexpr int kMmaCols = 128;         // byte columns per step
constexpr int kMmaSteps = 16;         // steps per block: 2048 columns
constexpr int kTile = 256;            // bytes of one 16x16 int8 tile
constexpr size_t kMaxSmem = 232448;   // H100: 227 KB a block can use

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

// NQ = ceil(k/4) 32-bit words per W row; word q of row 8i+s holds W bits
// 32q..32q+31, i.e. chunks 4q..4q+3.
template <int NQ>
__global__ void __launch_bounds__(kPopcThreads)
gf2_popc_kernel(const uint32_t* __restrict__ wpk, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int k, int r, long long L, bool vec) {
  extern __shared__ uint32_t w_s[];
  for (int i = threadIdx.x; i < 8 * r * NQ; i += blockDim.x) w_s[i] = wpk[i];
  __syncthreads();

  const long long b = blockIdx.y;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kPopcCols;
  if (c0 >= L) return;

  const uint8_t* src = data + b * k * L;
  uint32_t col[kPopcCols][NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    uint32_t v[4], t[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj;
      v[jj] = j < k ? load4(src + j * L, c0, L, vec) : 0u;
    }
    transpose4(v, t);
#pragma unroll
    for (int c = 0; c < kPopcCols; ++c) col[c][q] = t[c];
  }

  uint8_t* dst = out + b * r * L;
  for (int i = 0; i < r; ++i) {
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
    store4(dst + i * L, c0, L, vec, word);
  }
}

// KT = padded contraction / 16.  wt: W_gN zero-padded to (16*MT, 16*KT) and
// laid out tile-major (MT, KT, 16, 16), so every wmma operand starts on a
// 256-byte boundary.  Bit planes in shared memory are tile-major (KT, 8, 16, 16).
template <int KT>
__global__ void __launch_bounds__(kMmaThreads)
gf2_mma_kernel(const int8_t* __restrict__ wt, const uint8_t* __restrict__ data,
               uint8_t* __restrict__ out, int k, int r, int g, int MT, long long L) {
  extern __shared__ __align__(256) unsigned char smem[];
  signed char* w_s = reinterpret_cast<signed char*>(smem);
  signed char* bits_s = w_s + MT * KT * kTile;
  int* scratch = reinterpret_cast<int*>(bits_s + KT * 8 * kTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gk = g * k;

  for (int i = tid; i < MT * KT * kTile / 16; i += kMmaThreads)
    reinterpret_cast<int4*>(w_s)[i] = reinterpret_cast<const int4*>(wt)[i];
  // rows past 8*g*k are contraction padding: zero once, unpack never writes them
  for (int i = tid; i < KT * 8 * kTile / 16; i += kMmaThreads)
    reinterpret_cast<int4*>(bits_s)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long b0 = static_cast<long long>(blockIdx.y) * g;
  const uint8_t* src = data + b0 * k * L;   // g stripes = g*k consecutive rows
  const long long col_begin = static_cast<long long>(blockIdx.x) * kMmaCols * kMmaSteps;
  const long long col_end = min(L, col_begin + kMmaCols * kMmaSteps);
  int* sc = scratch + warp * kTile;

  for (long long c0 = col_begin; c0 < col_end; c0 += kMmaCols) {
    // unpack: item e = (n-tile nt, chunk row j) -> 16 bytes -> 8 plane rows
    for (int e = tid; e < gk * 8; e += kMmaThreads) {
      const int nt = e / gk, j = e - nt * gk;
      const uint4 v = *reinterpret_cast<const uint4*>(src + j * L + c0 + nt * 16);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int R = s * gk + j;
        uint4 p;
        p.x = (v.x >> s) & 0x01010101u;
        p.y = (v.y >> s) & 0x01010101u;
        p.z = (v.z >> s) & 0x01010101u;
        p.w = (v.w >> s) & 0x01010101u;
        *reinterpret_cast<uint4*>(bits_s + ((R >> 4) * 8 + nt) * kTile + (R & 15) * 16) = p;
      }
    }
    __syncthreads();

    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wmma::load_matrix_sync(bf[kk], bits_s + (kk * 8 + warp) * kTile, 16);

    const int h = lane >> 4, col = lane & 15;
    for (int mt = 0; mt < MT; ++mt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
        wmma::load_matrix_sync(af, w_s + (mt * KT + kk) * kTile, 16);
        wmma::mma_sync(acc, af, bf[kk], acc);
      }
      wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
      __syncwarp();
      // lane -> byte row h of this m-tile (W rows 16mt+8h .. +7), column col
      const int q = mt * 2 + h;   // output byte row = stripe * r + i
      if (q < g * r) {
        uint32_t byte = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          byte |= static_cast<uint32_t>(sc[(8 * h + t) * 16 + col] & 1) << t;
        const int stripe = q / r, i = q - stripe * r;
        out[((b0 + stripe) * r + i) * L + c0 + warp * 16 + col] = static_cast<uint8_t>(byte);
      }
      __syncwarp();
    }
    __syncthreads();   // the next step overwrites bits_s
  }
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

template <int NQ>
cudaError_t launch_popc(const void* wpk, const void* data, void* out, int B, int k,
                        int r, long long L, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(8) * r * NQ * sizeof(uint32_t);
  cudaError_t err = prepare_smem(gf2_popc_kernel<NQ>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(kPopcThreads) * kPopcCols;
  const dim3 grid(static_cast<unsigned>((L + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  const bool vec = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  gf2_popc_kernel<NQ><<<grid, kPopcThreads, smem, stream>>>(
      static_cast<const uint32_t*>(wpk), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), k, r, L, vec);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_mma(const void* wt, const void* data, void* out, int B, int k,
                       int r, int g, long long L, cudaStream_t stream) {
  const int MT = (g * r + 1) / 2;   // 16-row m-tiles of the g*8r W rows
  const size_t smem = static_cast<size_t>(MT * KT + KT * 8 + 8 * 4) * kTile;
  cudaError_t err = prepare_smem(gf2_mma_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(kMmaCols) * kMmaSteps;
  const dim3 grid(static_cast<unsigned>((L + per_block - 1) / per_block),
                  static_cast<unsigned>(B / g));
  gf2_mma_kernel<KT><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const int8_t*>(wt), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), k, r, g, MT, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wpk: (8r, ceil(k/4)) uint32 packed W rows; data (B,k,L) uint8; out (B,r,L).
int gf2_matmul_popc(const void* wpk, const void* data, void* out, int B, int k,
                    int r, long long L, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (B < 1 || B > 65535 || k < 1 || k > 32 || r < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 3) / 4) {
    case 1: return static_cast<int>(launch_popc<1>(wpk, data, out, B, k, r, L, s));
    case 2: return static_cast<int>(launch_popc<2>(wpk, data, out, B, k, r, L, s));
    case 3: return static_cast<int>(launch_popc<3>(wpk, data, out, B, k, r, L, s));
    case 4: return static_cast<int>(launch_popc<4>(wpk, data, out, B, k, r, L, s));
    case 5: return static_cast<int>(launch_popc<5>(wpk, data, out, B, k, r, L, s));
    case 6: return static_cast<int>(launch_popc<6>(wpk, data, out, B, k, r, L, s));
    case 7: return static_cast<int>(launch_popc<7>(wpk, data, out, B, k, r, L, s));
    default: return static_cast<int>(launch_popc<8>(wpk, data, out, B, k, r, L, s));
  }
}

// wt: W_gN padded and tile-major, (ceil(g*r/2), ceil(g*k/2), 16, 16) int8;
// data (B,k,L) uint8 with L % 128 == 0 and 16-byte aligned; out (B,r,L).
int gf2_matmul_mma(const void* wt, const void* data, void* out, int B, int k,
                   int r, int g, long long L, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (g < 1 || B < g || B % g || B / g > 65535 || k < 1 || 8 * g * k > 128 ||
      r < 1 || L < 1 || L % kMmaCols ||
      reinterpret_cast<uintptr_t>(data) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((g * k + 1) / 2) {
    case 1: return static_cast<int>(launch_mma<1>(wt, data, out, B, k, r, g, L, s));
    case 2: return static_cast<int>(launch_mma<2>(wt, data, out, B, k, r, g, L, s));
    case 3: return static_cast<int>(launch_mma<3>(wt, data, out, B, k, r, g, L, s));
    case 4: return static_cast<int>(launch_mma<4>(wt, data, out, B, k, r, g, L, s));
    case 5: return static_cast<int>(launch_mma<5>(wt, data, out, B, k, r, g, L, s));
    case 6: return static_cast<int>(launch_mma<6>(wt, data, out, B, k, r, g, L, s));
    case 7: return static_cast<int>(launch_mma<7>(wt, data, out, B, k, r, g, L, s));
    default: return static_cast<int>(launch_mma<8>(wt, data, out, B, k, r, g, L, s));
  }
}

}  // extern "C"
