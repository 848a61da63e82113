"""Kernel K4 (``crc32c_chunks``) built as host C++ and held against ceph_tpu.

``csrc/crc32c.cu`` compiles without ``__CUDACC__`` when the includer
supplies the CUDA built-ins it uses.  The harness below runs each block's
threads as host threads (a barrier for ``__syncthreads``, one per warp for
the shuffle) at the grid the C entry would launch, with the segment plan and
constants of ``crc32c_batch.crc_plan`` / ``_consts``.  That checks the
segment split, the slice-by-8 and byte paths, the misaligned head and the
fold tree (inside a warp and across warps) without a card, against the
reference package's CRCs, bit for bit.  The card runs it in
``chip_smoke.py``.

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

HARNESS = r"""
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
inline dim3 blockDim;
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline std::vector<std::vector<uint32_t>> warp_posts;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  warp_posts[w][l] = v;
  warp_barriers[w]->arrive_and_wait();
  const uint32_t r = l + d < 32 ? warp_posts[w][l + d] : v;
  warp_barriers[w]->arrive_and_wait();
  return r;
}
namespace { alignas(256) unsigned char smem[65536]; }
#include "crc32c.cu"
// the grid the C entry launches, each block's threads at once
extern "C" __attribute__((visibility("default")))
int k4_host(const void* data, void* out, long long n, long long l, long long seg,
            int log_s, unsigned seed, const void* consts) {
  const int threads = (1 << log_s) > kCrcMinThreads ? (1 << log_s) : kCrcMinThreads;
  const long long blocks = ((n << log_s) + threads - 1) / threads;
  std::memset(smem, 0xA5, sizeof smem);   // stale bytes, as on the card
  blockDim.x = threads;
  for (long long bx = 0; bx < blocks; ++bx) {
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
        crc32c_rows_kernel(static_cast<const uint8_t*>(data), static_cast<uint32_t*>(out),
                           n, l, seg, log_s, seed, static_cast<const uint32_t*>(consts));
      });
    for (auto& th : pool) th.join();
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K4's source for the CPU")
    tmp = tmp_path_factory.mktemp("k4_host")
    src = tmp / "k4_host.cpp"
    src.write_text(HARNESS)
    lib = tmp / "libk4_host.so"
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    "-fvisibility=hidden", "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    dll.k4_host.argtypes = [v, v, ll, ll, ll, ctypes.c_int, ctypes.c_uint, v]
    dll.k4_host.restype = ctypes.c_int
    return dll.k4_host


CASES = {   # label: (rows, row bytes, misaligned base)
    "one byte": (1, 1, False),
    "l % 8 != 0, one segment": (5, 127, False),
    "ragged first segment, S=16": (3, 4099, False),
    "misaligned base": (3, 4099, True),
    "two rows a block, rows past n (S=64)": (3, 16384, False),
    "S=256: fold across warps": (1, 65536 + 5, False),
    "S=1024: one row a block": (1, 262144 + 13, True),
}


@pytest.mark.parametrize("label", list(CASES))
def test_k4_host_build_matches_reference(k4_host, label):
    n, l, misaligned = CASES[label]
    rng = np.random.default_rng(list(CASES).index(label))
    host = rng.integers(0, 256, (n, l), dtype=np.uint8)
    buf = np.zeros(n * l + 17, np.uint8)
    off = 16 - (buf.ctypes.data % 16) + (1 if misaligned else 0)
    x = buf[off:off + n * l].reshape(n, l)
    x[:] = host
    log_s, seg = crc.crc_plan(n, l)
    consts = crc._consts(seg, log_s, torch.device("cpu")).numpy()
    out = np.zeros(n, np.uint32)
    assert k4_host(x.ctypes.data, out.ctypes.data, n, l, seg, log_s,
                   crc.SEED, consts.ctypes.data) == 0
    assert np.array_equal(out, ref_crc.crc32c_rows(host, backend="numpy"))
    assert np.array_equal(out, np.asarray(ref_crc.crc32c_device_chunks(host)))
