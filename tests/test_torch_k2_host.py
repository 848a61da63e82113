"""Kernels K2 (``gf2_matmul_mma``) and K1 (``gf2_matmul_popc``) built as host
C++ and held against ceph_tpu.

``csrc/gf2_matmul.cu`` compiles without ``__CUDACC__`` when the includer
supplies the CUDA built-ins it uses.  The harness below runs each block's
threads as host threads (a barrier for ``__syncthreads``, one per warp for
``__syncwarp``), emulates the warp shuffle, ``mma.sync.m16n8k32.u8`` and
``mma.sync.m16n8k256.b1.and.popc`` in the PTX ISA's fragment layouts, and
calls the kernel at the grid ``gf2_matmul_mma`` would launch.  That checks
K2's staging ring, operand order, W permutation, parity pack and output
stores without a card, against the reference package's host GF(2^8) oracle,
byte for byte.  K1 runs the same way, one launch per ``popc_stripes`` range
and ``popc_plan`` row tile, on a grid of one to three blocks whose warps walk
the (stripe, tile) pairs, so its k-steps (k > 32, in registers and reloaded),
its ring of staged tiles (cp.async with zero fill, or plain loads), its row
groups and tiles, and the split of a batch into launches on offset base
pointers are checked too (at a stripe cap of a few, as
``POPC_MAX_STRIPES`` = 65535 splits a larger batch on the card).  The
emulated b1 MMA is itself held against a plain popcount of AND on random
fragments.  The card itself runs both in ``chip_smoke.py``.

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
// mma.m16n8k256 b1 AND-popc: a.x/a.y rows grp/grp+8 at k 32tig.. (bit k % 32),
// a.z/a.w at k+128; b.x column grp at k 32tig.., b.y at k+128; d as above
inline void host_mma_b1(int (&d)[4], const uint4& a, const uint2& b) {
  auto& p = warp_posts[threadIdx.x / 32];
  const int l = threadIdx.x % 32;
  p.a[l][0] = a.x; p.a[l][1] = a.y; p.a[l][2] = a.z; p.a[l][3] = a.w;
  p.b[l][0] = b.x; p.b[l][1] = b.y;
  __syncwarp();
  auto A = [&](int row, int k) {
    return (p.a[4 * (row & 7) + ((k & 127) >> 5)][(row >= 8) + 2 * (k >= 128)] >> (k & 31)) & 1u;
  };
  auto B = [&](int k, int col) {
    return (p.b[4 * col + ((k & 127) >> 5)][k >= 128] >> (k & 31)) & 1u;
  };
  int nd[4];
  for (int i = 0; i < 4; ++i) {
    const int row = l / 4 + 8 * (i >= 2), col = 2 * (l % 4) + (i & 1);
    int s = d[i];
    for (int k = 0; k < 256; ++k) s += int(A(row, k) & B(k, col));
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
// one warp calling mma_b1 (the kernel's own wrapper): a (32, 4), b (32, 2)
// and d (32, 4) words by lane; d accumulates
extern "C" HOST_ENTRY int mma_b1_host(const uint32_t* a, const uint32_t* b, int* d) {
  run_block(0, 32, [&] {
    const int l = threadIdx.x;
    int acc[4] = {d[4 * l], d[4 * l + 1], d[4 * l + 2], d[4 * l + 3]};
    mma_b1(acc, make_uint4(a[4 * l], a[4 * l + 1], a[4 * l + 2], a[4 * l + 3]),
           make_uint2(b[2 * l], b[2 * l + 1]));
    __syncwarp();
    for (int i = 0; i < 4; ++i) d[4 * l + i] = acc[i];
  });
  return 0;
}
// one K1 launch (gf2_matmul_popc's checks aside) on a grid of `blocks`
// blocks, whose warps walk the tiles, staging with the instance
// gf2_matmul_popc picks (cp.async: the host build copies at once)
extern "C" HOST_ENTRY int k1_host(const void* wfrag, const void* data, void* out, int B,
                                  int k, int r, int i0, int rg, long long L, int blocks) {
  const bool async16 = L % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  const PopcKernel kernel = popc_kernel_for(k, rg, async16);
  if (popc_smem_bytes(k, rg) > sizeof smem) return 1;
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  std::memset(smem, 0xA5, sizeof smem);   // stale bytes, as on the card
  blockDim.x = kPopcThreads;
  gridDim.x = blocks;
  gridDim.y = 1;
  for (unsigned bx = 0; bx < gridDim.x; ++bx)
    run_block(bx, kPopcThreads, [&] {
      kernel(static_cast<const uint2*>(wfrag), static_cast<const uint8_t*>(data),
             static_cast<uint8_t*>(out), B, k, r, i0, rg, L, vec);
    });
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


def _build_harness(tmp, knobs: dict | None = None) -> ctypes.CDLL:
    """The harness over ``csrc/gf2_matmul.cu``, or over a copy with the
    ``constexpr int`` knobs set (``k1_time.py --set`` builds the same)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K1/K2's source for the CPU")
    inc = _build.CSRC
    if knobs:
        from ceph_tpu_torch.tools.k2_sweep import variant_text
        inc = tmp
        (tmp / "gf2_matmul.cu").write_text(variant_text(
            (_build.CSRC / "gf2_matmul.cu").read_text(), knobs))
    src = tmp / "k2_host.cpp"
    src.write_text(HARNESS)
    lib = tmp / "libk2_host.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    "-fvisibility=hidden", "-I", str(inc), "-o",
                    str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.k2_host.argtypes = [v, v, v, i, i, i, i, ll]
    dll.k2_host.restype = i
    dll.k1_host.argtypes = [v, v, v, i, i, i, i, i, ll, i]
    dll.k1_host.restype = i
    dll.mma_b1_host.argtypes = [v, v, v]
    dll.mma_b1_host.restype = i
    return dll


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_harness(tmp_path_factory.mktemp("k2_host"))


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


def _pmsr5():
    codec = ErasureCodePmsr("cpu")
    codec.init({"k": "5", "m": "4"})
    return codec


K1_CASES = {   # label: (matrix, B, L, stripes a launch, rows a launch, blocks)
    "rs8/3 ragged L, grid-stride": (RS83[8:], 3, 1001, 2, 256, 3),
    "rs8/3 misaligned rows (L % 4)": (RS83[8:], 2, 130, 1, 256, 1),
    # two k-steps (42 = 32 + 10 chunks) in registers, nine row groups
    "pmsr7/6 parity 36x42": (_pmsr7().parity_matrix, 2, 64, 1, 256, 1),
    # three k-steps: A reloaded per row group, W read from global memory
    "k=72 (three chunk groups)": (
        np.random.default_rng(9).integers(0, 256, (3, 72), dtype=np.uint8), 3, 40, 2,
        256, 1),
    "k=33, one row": (
        np.random.default_rng(10).integers(0, 256, (1, 33), dtype=np.uint8), 1, 1, 1,
        256, 1),
    "pmsr5/4 parity 16x20": (_pmsr5().parity_matrix, 2, 200, 1, 256, 1),
    # 13 chunks: the last W word and the k-step are both partial
    "random 5x13": (
        np.random.default_rng(11).integers(0, 256, (5, 13), dtype=np.uint8), 2, 2100,
        1, 256, 2),
    # row tiles of 8 rows: launches at i0 = 0, 8, ..., 32 (the last of 4 rows)
    "pmsr7/6 in row tiles of 8": (_pmsr7().parity_matrix, 1, 100, 1, 8, 1),
    # staged with cp.async (L % 16 == 0): the last tile's pieces past L are
    # zero-filled, and one block's warps wrap their ring of tiles
    "rs8/3 staged, ragged last tile": (RS83[8:], 3, 1008, 2, 256, 1),
    "pmsr5/4 staged, 2 blocks": (_pmsr5().parity_matrix, 2, 4112, 1, 256, 2),
}


def _run_k1(lib, mat, x, most_rows, blocks) -> np.ndarray:
    """K1's launches on the host build, as ``gf2_matmul_popc`` makes them,
    each on a grid of ``blocks`` blocks (their warps walk the tiles)."""
    r, k = mat.shape
    b, _, l = x.shape
    out = np.full((b, r, l), 0x5A, np.uint8)
    w = gk.bitmatrix_i8(mat)
    plan = [(i0, min(most_rows, r - i0)) for i0 in range(0, r, most_rows)]
    for b0, nb in gk.popc_stripes(b):
        for i0, rg in plan:
            frag = np.ascontiguousarray(gk.popc_fragments(w, i0, rg))
            assert lib.k1_host(frag.ctypes.data, x[b0:].ctypes.data,
                               out[b0:].ctypes.data, nb, k, r, i0, rg, l,
                               blocks) == 0
    return out


@pytest.mark.parametrize("label", list(K1_CASES))
def test_k1_host_build_matches_reference_oracle(host_lib, label, monkeypatch):
    mat, b, l, most, most_rows, blocks = K1_CASES[label]
    monkeypatch.setattr(gk, "POPC_MAX_STRIPES", most)
    mat = np.ascontiguousarray(mat, np.uint8)
    x = np.random.default_rng(len(label)).integers(0, 256, (b, mat.shape[1], l),
                                                   dtype=np.uint8)
    out = _run_k1(host_lib, mat, x, most_rows, blocks)
    want = np.stack([ref_gf.gf_matmul(mat, x[i]) for i in range(b)])
    assert np.array_equal(out, want)


def test_emulated_b1_mma_is_a_popcount_of_and(host_lib):
    """mma_b1 on the host build == A @ B + C over random bits, with A, B
    and C handed to the lanes in the PTX ISA's m16n8k256 .b1 layout."""
    rng = np.random.default_rng(12)
    for _ in range(3):
        a_bits = rng.integers(0, 2, (16, 256), dtype=np.uint8)
        b_bits = rng.integers(0, 2, (256, 8), dtype=np.uint8)
        c = rng.integers(-1000, 1000, (16, 8)).astype(np.int32)

        def word(bits):   # 32 bits, element i at bit i
            return int(np.packbits(bits, bitorder="little").view("<u4")[0])
        a = np.zeros((32, 4), np.uint32)
        b = np.zeros((32, 2), np.uint32)
        d = np.zeros((32, 4), np.int32)
        for lane in range(32):
            grp, tig = divmod(lane, 4)
            for reg in range(4):
                row, k0 = grp + 8 * (reg & 1), 32 * tig + 128 * (reg >> 1)
                a[lane, reg] = word(a_bits[row, k0:k0 + 32])
            for reg in range(2):
                k0 = 32 * tig + 128 * reg
                b[lane, reg] = word(b_bits[k0:k0 + 32, grp])
            for reg in range(4):
                d[lane, reg] = c[grp + 8 * (reg >> 1), 2 * tig + (reg & 1)]
        assert host_lib.mma_b1_host(a.ctypes.data, b.ctypes.data,
                                    d.ctypes.data) == 0
        want = a_bits.astype(np.int32) @ b_bits.astype(np.int32) + c
        for lane in range(32):
            grp, tig = divmod(lane, 4)
            for reg in range(4):
                assert d[lane, reg] == want[grp + 8 * (reg >> 1), 2 * tig + (reg & 1)]


K1_VARIANTS = {   # the knobs k1_time.py --set times, on cases they change
    "4 warps, 128-column tiles": {"kPopcWarps": 4, "kPopcMaxSpan": 2},
    "a ring of 3, 64-column tiles": {"kPopcRing": 3, "kPopcMaxSpan": 1},
}


@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_k1_knob_variants_match_reference_oracle(tmp_path, variant):
    lib = _build_harness(tmp_path, K1_VARIANTS[variant])
    for label in ("pmsr7/6 parity 36x42", "k=72 (three chunk groups)",
                  "random 5x13", "rs8/3 staged, ragged last tile"):
        mat, b, l, _, most_rows, blocks = K1_CASES[label]
        mat = np.ascontiguousarray(mat, np.uint8)
        x = np.random.default_rng(len(label)).integers(
            0, 256, (b, mat.shape[1], l), dtype=np.uint8)
        want = np.stack([ref_gf.gf_matmul(mat, x[i]) for i in range(b)])
        assert np.array_equal(_run_k1(lib, mat, x, most_rows, blocks), want), \
            label
