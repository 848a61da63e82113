"""Kernel K5 (``crush_map_rule``) built as host C++ and held lane by lane.

``csrc/crush.cu`` compiles without ``__CUDACC__`` when the includer supplies
the CUDA built-ins it uses.  The harness below runs a small grid's blocks one
after another, each block's threads as host threads (a barrier for
``__syncthreads``), so the grid-stride walk over the lanes, the staging of
the map and the crush_ln tables in shared memory, and every decision of the
firstn and indep loops run as on the card, against the port's plain version
and the reference's scalar engine on the maps of ``test_torch_crush.py``:
firstn and indep, with and without choose_args, reweights 0 / 0x4000 /
0x8000, seeds >= 2^31, the map staged and read from global memory.  The
card runs it in ``chip_smoke.py``.

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

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu_torch.crush import vectorized as vec
from ceph_tpu_torch.ops import _build
from test_torch_crush import CASE_IDS, CASES, MAPS, port_map, scalar_rows, seeds

HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline int __clz(int x) { return x ? __builtin_clz(static_cast<unsigned>(x)) : 32; }
namespace { alignas(256) unsigned char smem[262144]; }
#include "crush.cu"
static_assert(kLnWords * 8 + kMaxStagedWords * 4 <= sizeof smem);
// a grid of `blocks` blocks of `threads` threads, each block's threads at once
extern "C" __attribute__((visibility("default")))
int k5_host(const int* xs, long long n, int numrep, const int* osd_w, const int* map,
            int map_words, int staged, const long long* ln, int* out, int* sel, int blocks,
            int threads) {
  std::memset(smem, 0xA5, sizeof smem);   // stale bytes, as on the card
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx) {
    std::barrier<> bar(threads);
    block_barrier = &bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = static_cast<unsigned>(bx);
        crush_map_rule_kernel(xs, n, numrep, osd_w, map, map_words, staged, ln, out, sel);
      });
    for (auto& th : pool) th.join();
  }
  return stages(map_words) ? 1 : 0;
}
"""

# the harness's grid: lanes walk grid-stride over 2 blocks of 32 threads
BLOCKS, THREADS = 2, 32


@pytest.fixture(scope="module")
def k5_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K5's source for the CPU")
    tmp = tmp_path_factory.mktemp("k5_host")
    src = tmp / "k5_host.cpp"
    src.write_text(HARNESS)
    lib = tmp / "libk5_host.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    "-fvisibility=hidden", "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   text=True)
    dll = ctypes.CDLL(str(lib))
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.k5_host.argtypes = [v, ll, i, v, v, i, i, v, v, v, i, i]
    dll.k5_host.restype = i
    return dll.k5_host


def run_k5(k5_host, vc, xs: np.ndarray, numrep: int, weights,
           staged: bool = True) -> np.ndarray:
    """K5's rows for numpy seeds, with the wrapper's seeds, weights (padded
    to max_devices) and map words, the map staged or read from global
    memory."""
    x = (np.asarray(xs, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    w = vc.device_weights(weights).numpy()
    words = vc.map_words.numpy()
    ln = vec.ln_words(torch.device("cpu")).numpy()
    out = np.full((len(x), numrep), -5, np.int32)
    sel = np.full((len(x), numrep), -5, np.int32)
    # the harness returns whether the C entry would stage this map
    assert k5_host(x.ctypes.data, len(x), numrep, w.ctypes.data, words.ctypes.data,
                   len(words), int(staged), ln.ctypes.data, out.ctypes.data,
                   sel.ctypes.data, BLOCKS, THREADS) == 1
    return out


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "global"])
@pytest.mark.parametrize("name,rule", CASES, ids=CASE_IDS)
def test_k5_host_matches_plain_and_scalar(k5_host, name, rule, staged):
    cm, weights, rules = MAPS[name]
    numrep = rules[rule]
    xs = seeds(384, seed=23)
    vc = vec.VectorCrush(port_map(cm), rule, device="cpu")
    got = run_k5(k5_host, vc, xs, numrep, weights, staged)
    np.testing.assert_array_equal(got, vc.map_pgs(xs, numrep, weights))
    np.testing.assert_array_equal(got, scalar_rows(cm, rule, xs, numrep,
                                                   weights))


@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
def test_k5_host_exhausted_slots_and_short_weights(k5_host, rule):
    """Few OSDs in and weights shorter than max_devices: firstn exhausts
    its tries and compacts, indep leaves NONE holes in place; an OSD past
    the weights' end is out."""
    cm = ref_builder.build_two_level_map(4, 3)
    weights = [0, 0x10000, 0, 0x8000, 0, 0, 0x4000, 0, 0, 0]   # 10 of 12
    xs = seeds(64, seed=29)
    numrep = 4
    vc = vec.VectorCrush(port_map(cm), rule, device="cpu")
    got = run_k5(k5_host, vc, xs, numrep, weights)
    want = scalar_rows(cm, rule, xs, numrep, weights)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vc.map_pgs(xs, numrep, weights))
    assert (got == vec.CRUSH_ITEM_NONE).any()
    if rule == 0:       # compacted: no placed OSD after a hole
        holes = got == vec.CRUSH_ITEM_NONE
        assert (holes[:, :-1] <= holes[:, 1:]).all()


def test_k5_host_positions_past_the_weight_sets(k5_host):
    """indep at numrep 7 on a weight-set of 3 positions: slots 3..6 draw
    their leaves at position 2 (clipped)."""
    cm, weights, _ = MAPS["choose_args"]
    xs = seeds(256, seed=31)
    vc = vec.VectorCrush(port_map(cm), 1, device="cpu")
    got = run_k5(k5_host, vc, xs, 7, weights)
    np.testing.assert_array_equal(got, vc.map_pgs(xs, 7, weights))
    np.testing.assert_array_equal(got, scalar_rows(cm, 1, xs, 7, weights))
