// Throughput of the tensor-core products K1 and K2 issue, for Hopper (sm_90a).
//
// mma_rate_kernel keeps kChains independent accumulators a warp and issues
// `iters` rounds of one mma.sync each into every chain: kind 0 the
// single-bit m16n8k256 .b1 .and.popc product (K1), kind 1 the u8 m16n8k32
// product (K2).  No card's data sheet gives the single-bit rate, so
// tools/mma_rate.py times this kernel and reads it as MMAs a clock a SM;
// chip_smoke.py takes the b1 rate as that product's peak in K1's bounds.
// Operands come from the thread index, so nothing is read from memory; the
// sums go to `sink` so the products are not optimised away.  Plain C
// interface for ctypes, as csrc/gf2_matmul.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int kKind>
__global__ void __launch_bounds__(kThreads) mma_rate_kernel(int iters, int* sink) {
  const uint32_t t = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a0 = t, a1 = t ^ 0x5bd1e995u, a2 = t * 3u, a3 = ~t, b0 = t >> 3,
                 b1 = t * 7u;
  int d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if constexpr (kKind == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += d[c][0] ^ d[c][1] ^ d[c][2] ^ d[c][3];
  sink[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// `blocks` blocks of 256 threads, each warp issuing iters * 8 MMAs of
// `kind` (0: b1 m16n8k256, 1: u8 m16n8k32); sink: blocks * 256 ints.
int mma_rate(int kind, int blocks, int iters, void* sink, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || iters < 1 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kind == 0 ? mma_rate_kernel<0> : mma_rate_kernel<1>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
