"""Kernel K4 (``crc32c_chunks``) built as host C++ and held against ceph_tpu.

``csrc/crc32c.cu`` compiles without ``__CUDACC__`` when the includer
supplies the CUDA built-ins it uses.  The harness below runs each block's
threads as host threads (a barrier for ``__syncthreads``, one per warp for
the shuffles and the warp reduction, ``std::atomic_ref`` for ``atomicXor``)
over a small grid that walks the (row, span) items as the card's does, with
the span plan, seed term and constants of ``crc32c_batch.crc_plan`` /
``_seed_term`` / ``_consts``.  That checks the braid (four streams a lane,
the 508-byte gap folded into the tables), the masked loads at a row's ends,
the Horner and shuffle folds, the ladder over the spans after a span and
the strip of the end's padding, without a card, against the reference
package's CRCs, bit for bit.  The card runs it in ``chip_smoke.py``.

The harness is built with hidden visibility: its CUDA stand-ins are inline
variables, which would otherwise be process-wide unique symbols shared with
(and clobbered by) another harness loaded into the same process, such as
K2's.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c_batch as ref_crc
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import crc32c_batch as crc
from ceph_tpu_torch.tools.k2_sweep import variant_text

HARNESS = r"""
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct uint4 { uint32_t x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline std::vector<std::vector<uint32_t>> warp_posts;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// every lane posts v; f reads the warp's posts
template <class F>
inline uint32_t warp_exchange(uint32_t v, F f) {
  const int w = threadIdx.x / 32;
  warp_posts[w][threadIdx.x % 32] = v;
  warp_barriers[w]->arrive_and_wait();
  const uint32_t r = f(warp_posts[w]);
  warp_barriers[w]->arrive_and_wait();
  return r;
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
  const int l = threadIdx.x % 32;
  return warp_exchange(v, [&](auto& p) { return l + d < 32 ? p[l + d] : v; });
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  return warp_exchange(v, [&](auto& p) { return p[src]; });
}
inline uint32_t __reduce_xor_sync(unsigned, uint32_t v) {
  return warp_exchange(v, [](auto& p) {
    uint32_t r = 0;
    for (uint32_t x : p) r ^= x;
    return r;
  });
}
inline uint4 __ldcs(const uint4* p) { return *p; }
inline uint32_t atomicXor(uint32_t* a, uint32_t v) {
  return std::atomic_ref<uint32_t>(*a).fetch_xor(v);
}
namespace { alignas(256) unsigned char smem[262144]; }
#include "crc32c.cu"
static_assert(kSmemWords * 4 <= sizeof smem);
// a grid of `blocks` blocks of `threads` threads, each block's threads at once
extern "C" __attribute__((visibility("default")))
int k4_host(const void* a, long long na, const void* b, long long nb, void* out,
            long long l, int rounds, long long spans, const void* consts, int n_ladder,
            int blocks, int threads) {
  std::memset(smem, 0xA5, sizeof smem);   // stale bytes, as on the card
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx) {
    std::barrier<> bar(threads);
    block_barrier = &bar;
    warp_barriers.clear();
    warp_posts.assign(threads / 32, std::vector<uint32_t>(32));
    for (int w = 0; w < threads / 32; ++w)
      warp_barriers.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = static_cast<unsigned>(bx);
        crc32c_rows_kernel(static_cast<const uint8_t*>(a), na, static_cast<const uint8_t*>(b),
                           static_cast<uint32_t*>(out), l, rounds, spans, (na + nb) * spans,
                           static_cast<const uint32_t*>(consts), n_ladder);
      });
    for (auto& th : pool) th.join();
  }
  return 0;
}
"""

# the harness's grid: a few blocks of two warps, which walk every item
BLOCKS, THREADS = 3, 64


def build_harness(tmp, source: str | None = None):
    """The harness around ``csrc/crc32c.cu`` (or ``source``, a variant of
    it), built with the host compiler; its ``k4_host`` entry."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K4's source for the CPU")
    src = tmp / "k4_host.cpp"
    src.write_text(HARNESS)
    if source is not None:
        (tmp / "crc32c.cu").write_text(source)
    lib = tmp / "libk4_host.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    "-fvisibility=hidden", "-I", str(tmp), "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.k4_host.argtypes = [v, ll, v, ll, v, ll, i, ll, v, i, i, i]
    dll.k4_host.restype = i
    return dll.k4_host


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("k4_host"))


def rows_at(buf_rng, host: np.ndarray, misaligned: bool) -> np.ndarray:
    """``host`` copied into a buffer at a 16-byte aligned address (plus one
    byte if ``misaligned``) with slack on both sides, as a card's
    allocation has around a tensor's rows."""
    buf = buf_rng.integers(0, 256, host.size + 64, dtype=np.uint8)
    off = 32 - (buf.ctypes.data % 16) + (1 if misaligned else 0)
    x = buf[off:off + host.size].reshape(host.shape)
    x[:] = host
    return x


def run_k4(k4_host, parts: list[np.ndarray], rounds: int | None = None):
    """K4's CRCs of the rows of one or two (n_i, l) arrays in one launch,
    with the wrapper's plan (``rounds`` overrides its span length)."""
    l = parts[0].shape[1]
    n = sum(p.shape[0] for p in parts)
    aligned = l % 16 == 0 and all(p.ctypes.data % 16 == 0 for p in parts)
    plan_rounds, spans = crc.crc_plan(n, l, aligned)
    if rounds is not None:
        reach = l if aligned else l + crc._EDGE_SLACK
        spans = -(-reach // (512 * rounds))
    rounds = rounds or plan_rounds
    n_ladder = (spans - 1).bit_length()
    consts = crc._consts(rounds, n_ladder, torch.device("cpu")).numpy()
    out = np.full(n, crc._seed_term(l, crc.SEED), np.int64)
    b = parts[1] if len(parts) > 1 else None
    assert k4_host(parts[0].ctypes.data, parts[0].shape[0],
                   None if b is None else b.ctypes.data,
                   0 if b is None else b.shape[0], out.ctypes.data, l, rounds,
                   spans, consts.ctypes.data, n_ladder, BLOCKS, THREADS) == 0
    return out.astype(np.uint32)


CASES = {   # label: (rows, row bytes, misaligned base, rounds or the plan's)
    "one byte": (1, 1, False, None),
    "l % 8 != 0, one segment": (5, 127, False, None),
    "ragged first segment, S=16": (3, 4099, False, None),
    "misaligned base": (3, 4099, True, None),
    "two rows a block, rows past n (S=64)": (3, 16384, False, None),
    "S=256: fold across warps": (1, 65536 + 5, False, None),
    "S=1024: one row a block": (1, 262144 + 13, True, None),
    "row shorter than one 512-B braid": (4, 300, False, None),
    "l = 16 mod 512": (3, 512 * 5 + 16, False, None),
    "ragged head, misaligned base": (3, 2048 + 7, True, None),
    "spans of 3 rounds cross warps and blocks": (2, 3 * 512 * 4 - 100, True, 3),
    "spans of 2 rounds, aligned rows": (5, 1024 * 6, False, 2),
    "spans of 32 rounds (16 KiB), aligned rows": (2, 131072, False, 32),
}


@pytest.mark.parametrize("label", list(CASES))
def test_k4_host_build_matches_reference(k4_host, label):
    n, l, misaligned, rounds = CASES[label]
    rng = np.random.default_rng(list(CASES).index(label))
    host = rng.integers(0, 256, (n, l), dtype=np.uint8)
    out = run_k4(k4_host, [rows_at(rng, host, misaligned)], rounds)
    assert np.array_equal(out, ref_crc.crc32c_rows(host, backend="numpy"))
    assert np.array_equal(out, np.asarray(ref_crc.crc32c_device_chunks(host)))


@pytest.mark.parametrize("misaligned", [False, True])
def test_k4_host_one_launch_data_and_parity(k4_host, misaligned):
    """The fused encode's entry: two arrays of rows in one launch."""
    rng = np.random.default_rng(40 + misaligned)
    l = 4096 + (5 if misaligned else 0)
    data = rng.integers(0, 256, (6, l), dtype=np.uint8)
    parity = rng.integers(0, 256, (3, l), dtype=np.uint8)
    out = run_k4(k4_host, [rows_at(rng, data, misaligned),
                           rows_at(rng, parity, False)])
    want = ref_crc.crc32c_rows(np.concatenate([data, parity]), backend="numpy")
    assert np.array_equal(out, want)


# the variants the card times against the committed knobs (k4_time.py --set)
VARIANTS = ["kCopies=1", "kCopies=8,kUnroll=4", "kUnroll=1", "kCopies=16,kUnroll=3"]


@pytest.mark.parametrize("knobs", VARIANTS)
def test_k4_host_variants_match_reference(tmp_path, knobs):
    text = variant_text((_build.CSRC / "crc32c.cu").read_text(),
                        {k: int(v) for k, v in
                         (kv.split("=") for kv in knobs.split(","))})
    run = build_harness(tmp_path, text)
    rng = np.random.default_rng(50)
    for n, l, misaligned, rounds in (
            CASES["spans of 3 rounds cross warps and blocks"],
            CASES["ragged head, misaligned base"]):
        host = rng.integers(0, 256, (n, l), dtype=np.uint8)
        out = run_k4(run, [rows_at(rng, host, misaligned)], rounds)
        assert np.array_equal(out, ref_crc.crc32c_rows(host, backend="numpy"))
