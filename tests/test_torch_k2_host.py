"""Kernels K2 (``gf2_matmul_mma``) and K1 (``gf2_matmul_popc``) built as host
C++ and held against ceph_tpu.

``csrc/gf2_matmul.cu`` compiles without ``__CUDACC__`` when the includer
supplies the CUDA built-ins it uses.  The harness below runs each block's
threads as host threads (a barrier for ``__syncthreads``, one per warp for
``__syncwarp``), emulates the warp shuffle and ``mma.sync.m16n8k32.u8`` in the
PTX ISA's fragment layouts, and calls the kernel at the grid ``gf2_matmul_mma``
would launch.  That checks K2's staging ring, operand order, W permutation,
parity pack and output stores without a card, against the reference package's
host GF(2^8) oracle, byte for byte.  K1 runs the same way, one launch per
``popc_stripes`` range and ``popc_plan`` tile, so its split-k tiles (k > 32)
and the split of a batch into launches on offset base pointers are checked
too (at a stripe cap of a few, as ``POPC_MAX_STRIPES`` = 65535 splits a
larger batch on the card).  The card itself runs both in ``chip_smoke.py``.

The harness is built with hidden visibility: its CUDA stand-ins are inline
variables, which would otherwise be process-wide unique symbols shared with
(and clobbered by) another harness loaded into the same process.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ceph_tpu.gf as ref_gf
from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
from ceph_tpu_torch.gf import build_decode_matrix, gen_cauchy1_matrix, gen_rs_matrix
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import gf2kernels as gk

HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::min;
#define HOST_ENTRY __attribute__((visibility("default")))
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp() { warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
inline int __popc(uint32_t v) { return __builtin_popcount(v); }
inline uint32_t __byte_perm(uint32_t a, uint32_t b, uint32_t s) {
  uint8_t in[8];
  for (int i = 0; i < 4; ++i) { in[i] = a >> (8 * i); in[4 + i] = b >> (8 * i); }
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t(in[(s >> (4 * i)) & 7]) << (8 * i);
  return r;
}
// what each lane of a warp posts for a warp-wide operation
struct WarpPost { uint32_t a[32][4], b[32][2], v[32]; };
inline std::vector<WarpPost> warp_posts(64);
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int mask) {
  auto& p = warp_posts[threadIdx.x / 32];
  const int l = threadIdx.x % 32;
  p.v[l] = v;
  __syncwarp();
  const uint32_t r = p.v[l ^ mask];
  __syncwarp();
  return r;
}
// mma.m16n8k32 u8: a.x/a.y rows grp/grp+8 at k 4tig.., a.z/a.w at k+16;
// b.x column grp at k 4tig.., b.y at k+16; d rows grp, grp+8, columns 2tig+e
inline void host_mma_u8(int (&d)[4], const uint4& a, const uint2& b) {
  auto& p = warp_posts[threadIdx.x / 32];
  const int l = threadIdx.x % 32;
  p.a[l][0] = a.x; p.a[l][1] = a.y; p.a[l][2] = a.z; p.a[l][3] = a.w;
  p.b[l][0] = b.x; p.b[l][1] = b.y;
  __syncwarp();
  auto A = [&](int row, int k) {
    return int((p.a[4 * (row & 7) + ((k & 15) >> 2)][(row >= 8) + 2 * (k >= 16)] >> (8 * (k & 3))) & 255);
  };
  auto B = [&](int k, int col) {
    return int((p.b[4 * col + ((k & 15) >> 2)][k >= 16] >> (8 * (k & 3))) & 255);
  };
  int nd[4];
  for (int i = 0; i < 4; ++i) {
    const int row = l / 4 + 8 * (i >= 2), col = 2 * (l % 4) + (i & 1);
    int s = d[i];
    for (int k = 0; k < 32; ++k) s += A(row, k) * B(k, col);
    nd[i] = s;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = nd[i];
}
namespace { alignas(256) unsigned char smem[232448]; }
#include "gf2_matmul.cu"
// run one block of `threads` threads, each calling body()
template <typename Body>
void run_block(unsigned bx, int threads, Body body, unsigned by = 0) {
  std::barrier<> bar(threads);
  block_barrier = &bar;
  warp_barriers.clear();
  for (int w = 0; w < (threads + 31) / 32; ++w)
    warp_barriers.emplace_back(new std::barrier<>(32));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx.x = t;
      blockIdx.x = bx;
      blockIdx.y = by;
      body();
    });
  for (auto& th : pool) th.join();
}
// one K1 launch (gf2_matmul_popc's checks aside): B stripes along grid.y
extern "C" HOST_ENTRY int k1_host(const void* wpk, const void* data, void* out, int B,
                                  int k, int j0, int kg, int r, int i0, int rg,
                                  long long L, int acc) {
  const PopcKernel kernel = popc_kernel_for(kg, acc != 0);
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  std::memset(smem, 0xA5, sizeof smem);
  const long long per_block = static_cast<long long>(kPopcThreads) * kPopcCols;
  blockDim.x = kPopcThreads;
  gridDim.x = static_cast<unsigned>((L + per_block - 1) / per_block);
  gridDim.y = B;
  for (unsigned by = 0; by < gridDim.y; ++by)
    for (unsigned bx = 0; bx < gridDim.x; ++bx)
      run_block(bx, kPopcThreads, [&] {
        kernel(static_cast<const uint32_t*>(wpk), static_cast<const uint8_t*>(data),
               static_cast<uint8_t*>(out), k, j0, kg, r, i0, rg, L, vec);
      }, by);
  return 0;
}
// gf2_matmul_mma's grid, each block's threads run at once
extern "C" HOST_ENTRY int k2_host(const void* wt, const void* data, void* out, int B, int k,
                       int r, int g, long long L) {
  const MmaKernel kernel = mma_kernel_for(k, r);
  if (mma_smem_bytes(mma_reg_w(k, r), mma_ntiles(k, r), mma_ksteps(k), r, g, k) >
      sizeof smem)
    return 1;
  const long long per_block = static_cast<long long>(kMmaCols) * kMmaSteps;
  const unsigned gx = static_cast<unsigned>((L + per_block - 1) / per_block);
  std::memset(smem, 0xA5, sizeof smem);   // stale bytes, as on the card
  blockDim.x = kMmaThreads;
  gridDim.x = static_cast<unsigned>(B / g) * gx;
  gridDim.y = 1;
  // grid.x = (stripe group, column block) pairs, column blocks fastest
  for (unsigned bx = 0; bx < gridDim.x; ++bx)
    run_block(bx, kMmaThreads, [&] {
      kernel(static_cast<const int8_t*>(wt), static_cast<const uint8_t*>(data),
             static_cast<uint8_t*>(out), k, r, g, L);
    });
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K2's source for the CPU")
    tmp = tmp_path_factory.mktemp("k2_host")
    src = tmp / "k2_host.cpp"
    src.write_text(HARNESS)
    lib = tmp / "libk2_host.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    "-fvisibility=hidden", "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.k2_host.argtypes = [v, v, v, i, i, i, i, ll]
    dll.k2_host.restype = i
    dll.k1_host.argtypes = [v, v, v, i, i, i, i, i, i, i, ll, i]
    dll.k1_host.restype = i
    return dll


@pytest.fixture(scope="module")
def k2_host(host_lib):
    return host_lib.k2_host


def _lrc():
    codec = ErasureCodeLrc("cpu")
    codec.init({"k": "8", "m": "4", "l": "3"})
    return codec


RS83 = gen_rs_matrix(11, 8)
CASES = {   # label: (matrix, B, L)
    "rs8/3 one step": (RS83[8:], 2, 128),
    # 64 steps a block: two whole blocks and a ragged third
    "rs8/3 blocks + ragged tail": (RS83[8:], 4, 2 * 8192 + 384),
    "rs8/3 g=1 (odd B)": (RS83[8:], 3, 512),
    "rs8/3 decode[1,9]": (build_decode_matrix(RS83, 8, [1, 9])[0], 4, 512),
    "cauchy10/4 decode[2,11]": (
        build_decode_matrix(gen_cauchy1_matrix(14, 10), 10, [2, 11])[0], 2, 256),
    "rs5/3 k=5": (gen_rs_matrix(8, 5)[5:], 2, 128),
    "lrc8/4/3 parity r=8": (_lrc().parity_matrix, 2, 640),
    "lrc8/4/3 local repair k=3": (_lrc().repair_matrix((1, 2, 3), (0,)), 4, 384),
    "rs4/2 g=4": (gen_rs_matrix(6, 4)[4:], 8, 256),
    "W in shared memory (40x4)": (
        np.random.default_rng(7).integers(0, 256, (40, 4), dtype=np.uint8), 2, 128),
    "one W row per n-tile (k=16)": (
        np.random.default_rng(8).integers(0, 256, (9, 16), dtype=np.uint8), 1, 256),
    # the largest counts, on both sides of the paired-row bound 8k < 128
    "all ones at k=15": (np.full((3, 15), 255, np.uint8), 1, 128),
    "all ones at k=16": (np.full((3, 16), 255, np.uint8), 1, 128),
}


@pytest.mark.parametrize("label", list(CASES))
def test_k2_host_build_matches_reference_oracle(k2_host, label):
    mat, b, l = CASES[label]
    mat = np.ascontiguousarray(mat, np.uint8)
    r, k = mat.shape
    g = gk.pick_group(k, b)
    rng = np.random.default_rng(list(CASES).index(label))
    x = rng.integers(0, 256, (b, k, l), dtype=np.uint8)
    if "all ones" in label:
        x[:] = 255
    wt = gk._w_mma_device(mat.tobytes(), r, k, g, torch.device("cpu")).numpy()
    out = np.full((b, r, l), 0x5A, np.uint8)
    assert k2_host(wt.ctypes.data, x.ctypes.data, out.ctypes.data, b, k, r, g,
                   l) == 0
    want = np.stack([ref_gf.gf_matmul(mat, x[i]) for i in range(b)])
    assert np.array_equal(out, want)


def test_sweep_variants_set_the_knobs_they_name():
    from ceph_tpu_torch.tools import k2_sweep
    base = (_build.CSRC / "gf2_matmul.cu").read_text()
    text = k2_sweep.variant_text(base, {"kMmaRing": 2, "kMmaSteps": 16})
    assert "constexpr int kMmaRing = 2;" in text
    assert "constexpr int kMmaSteps = 16;" in text
    assert text.count("\n") == base.count("\n")
    with pytest.raises(ValueError, match="kNoSuchKnob"):
        k2_sweep.variant_text(base, {"kNoSuchKnob": 1})


def test_mma_config_describes_a_cuda_kernel_only():
    with pytest.raises(ValueError, match="CUDA"):
        gk.mma_config(8, 3, 2, device="cpu")


def _pmsr7():
    codec = ErasureCodePmsr("cpu")
    codec.init({"k": "7", "m": "6"})
    return codec


K1_CASES = {   # label: (matrix, B, L, stripes a launch: POPC_MAX_STRIPES)
    "rs8/3 ragged L, grid-stride": (RS83[8:], 3, 1001, 2),
    "rs8/3 misaligned rows (L % 4)": (RS83[8:], 2, 130, 1),
    # split-k: 42 = 32 + 10 chunks, two launches into one output
    "pmsr7/6 parity 36x42": (_pmsr7().parity_matrix, 2, 64, 1),
    "k=72 (three chunk groups)": (
        np.random.default_rng(9).integers(0, 256, (3, 72), dtype=np.uint8), 3, 40, 2),
    "k=33, one row": (
        np.random.default_rng(10).integers(0, 256, (1, 33), dtype=np.uint8), 1, 1, 1),
}


@pytest.mark.parametrize("label", list(K1_CASES))
def test_k1_host_build_matches_reference_oracle(host_lib, label, monkeypatch):
    mat, b, l, most = K1_CASES[label]
    monkeypatch.setattr(gk, "POPC_MAX_STRIPES", most)
    mat = np.ascontiguousarray(mat, np.uint8)
    r, k = mat.shape
    x = np.random.default_rng(len(label)).integers(0, 256, (b, k, l),
                                                   dtype=np.uint8)
    out = np.full((b, r, l), 0x5A, np.uint8)
    tiles = gk._w_popc_device(mat.tobytes(), r, k, torch.device("cpu"))
    for b0, nb in gk.popc_stripes(b):
        for (j0, kg, i0, rg), w in zip(gk.popc_plan(k, r), tiles):
            w = np.ascontiguousarray(w.numpy())
            assert host_lib.k1_host(w.ctypes.data, x[b0:].ctypes.data,
                                    out[b0:].ctypes.data, nb, k, j0, kg, r,
                                    i0, rg, l, int(j0 > 0)) == 0
    want = np.stack([ref_gf.gf_matmul(mat, x[i]) for i in range(b)])
    assert np.array_equal(out, want)
