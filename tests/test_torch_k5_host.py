"""Kernel K5 (``crush_map_rule``) built as host C++ and held lane by lane.

``csrc/crush.cu`` compiles without ``__CUDACC__`` when the includer supplies
the CUDA built-ins it uses.  The harness below runs a small grid's blocks one
after another, each block's threads as host threads (a barrier for
``__syncthreads``), so the grid-stride walk over the lanes, the staging of
the map and the crush_ln tables in shared memory, and every decision of the
firstn and indep loops run as on the card, against the port's plain version
and the reference's scalar engine on the maps of ``test_torch_crush.py``:
firstn and indep, with and without choose_args, reweights 0 / 0x4000 /
0x8000, seeds >= 2^31, the map staged and read from global memory; and on
maps that reach the branches of its draw and of its one-step-a-pass loops:
a row of unequal weights beside uniform rows, padded columns (buckets of
unequal size), and few hosts under many slots, where indep fills its slots
over several rounds and firstn retries most replicas.  The card runs it in
``chip_smoke.py``.

The draw's division by the weight is a multiplier per weight
(``vectorized.straw2_magic``); the harness also runs that quotient, compiled
from ``crush.cu`` itself, on all 65,536 dividends ``crush_ln(u) - 2^48``
for every weight of the test maps and of BASELINE.md config 5, the edge
weights and a few thousand seeded random ones, against exact integer
division truncating toward zero.

The harness is built with hidden visibility: its CUDA stand-ins are inline
variables, which would otherwise be process-wide unique symbols shared with
(and clobbered by) another harness loaded into the same process.
"""

import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.ln import crush_ln_np
from ceph_tpu.crush.types import (CRUSH_RULE_SET_CHOOSE_TRIES,
                                  CRUSH_RULE_TAKE, RuleStep)
from ceph_tpu_torch.crush import vectorized as vec
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.tools.crush_bench import config5_map
from test_torch_crush import (
    CASE_IDS, CASES, EXPRESSED, MAPS, _vary_r, port_map, scalar_rows, seeds)

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
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return static_cast<unsigned long long>((static_cast<unsigned __int128>(a) * b) >> 64);
}
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
// 2^48 - crush_ln(u) for every u in [0, 0xffff]
extern "C" __attribute__((visibility("default")))
void k5_ln_gap(const long long* ln, unsigned long long* out) {
  for (uint32_t u = 0; u < 65536; ++u) out[u] = ln_gap(u, ln);
}
// out[i * 65536 + u] = straw2_quotient(2^48 - crush_ln(u), magic[i])
extern "C" __attribute__((visibility("default")))
void k5_quotients(const long long* ln, const unsigned long long* magic, int count,
                  unsigned long long* out) {
  for (int i = 0; i < count; ++i)
    for (uint32_t u = 0; u < 65536; ++u)
      out[static_cast<size_t>(i) * 65536 + u] = straw2_quotient(ln_gap(u, ln), magic[i]);
}
// straw2_key of one child
extern "C" __attribute__((visibility("default")))
unsigned long long k5_key(uint32_t x, int id, uint32_t r, unsigned long long magic,
                          const long long* ln) {
  return straw2_key(x, id, r, magic, ln);
}
"""

# the harness's grid: lanes walk grid-stride over 2 blocks of 32 threads
BLOCKS, THREADS = 2, 32


@pytest.fixture(scope="module")
def k5_lib(tmp_path_factory):
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
    dll.k5_ln_gap.argtypes = [v, v]
    dll.k5_ln_gap.restype = None
    dll.k5_quotients.argtypes = [v, v, i, v]
    dll.k5_quotients.restype = None
    u64 = ctypes.c_uint64
    dll.k5_key.argtypes = [ctypes.c_uint32, i, ctypes.c_uint32, u64, v]
    dll.k5_key.restype = u64
    return dll


@pytest.fixture(scope="module")
def k5_host(k5_lib):
    return k5_lib.k5_host


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


# -- the draw's quotient ------------------------------------------------------

LN = vec.ln_words(torch.device("cpu")).numpy()
U = np.arange(65536)
GAP = (1 << 48) - crush_ln_np(U).astype(np.int64)      # -(crush_ln(u) - 2^48)


def map_weights() -> np.ndarray:
    """Every straw2 weight and weight-set entry of the test maps and of
    BASELINE.md config 5."""
    ws = []
    maps = [cm for cm, _, _ in MAPS.values()] + [config5_map(1000)[0]]
    for cm in maps:
        for b in cm.buckets.values():
            ws += b.item_weights
        for arg in (getattr(cm, "choose_args", None) or {}).values():
            for row in arg.get("weight_set") or []:
                ws += row
    return np.unique(np.asarray(ws, np.int64))


def edge_weights() -> np.ndarray:
    ws = [1, 2, 3, 0xFFFF, 0x10000, 0x10001, 0xA0000, 2**31 - 1]
    ws += [2**k + d for k in range(1, 32) for d in (-1, 0, 1)]
    return np.unique([w for w in ws if 1 <= w <= 2**31 - 1])


def random_weights() -> np.ndarray:
    rng = np.random.default_rng(1021)
    wide = np.exp(rng.uniform(0, np.log(2**31 - 1), 1500)).astype(np.int64)
    near = rng.integers(1, 0x200000, 1500)
    return np.unique(np.clip(np.concatenate([wide, near]), 1, 2**31 - 1))


WEIGHT_SETS = {"maps": map_weights, "edges": edge_weights,
               "random": random_weights}


def test_k5_host_ln_gap_exhaustive(k5_lib):
    """2^48 - crush_ln(u) from 32-bit halves of x * rh, all 65,536 u."""
    got = np.empty(65536, np.uint64)
    k5_lib.k5_ln_gap(LN.ctypes.data, got.ctypes.data)
    np.testing.assert_array_equal(got.astype(np.int64), GAP)
    assert GAP.min() >= 1 and GAP.max() <= 1 << 48


@pytest.mark.parametrize("which", list(WEIGHT_SETS))
def test_k5_host_quotient_exhaustive(k5_lib, which):
    """The draw trunc((crush_ln(u) - 2^48) / w) from the multiplier, on all
    65,536 dividends, against exact integer division truncating toward
    zero."""
    weights = WEIGHT_SETS[which]()
    assert len(weights) >= (3 if which == "maps" else 60)
    magic = vec.straw2_magic(weights)
    assert (magic & ((1 << 56) - 1) < 1 << 51).all()
    dividend = -GAP                                   # crush_ln(u) - 2^48 < 0
    for lo in range(0, len(weights), 64):
        w = weights[lo:lo + 64]
        got = np.empty((len(w), 65536), np.uint64)
        k5_lib.k5_quotients(LN.ctypes.data, magic[lo:lo + 64].ctypes.data,
                            len(w), got.ctypes.data)
        want = np.where(dividend < 0, -((-dividend)[None] // w[:, None]),
                        dividend[None] // w[:, None])
        np.testing.assert_array_equal(-got.astype(np.int64), want)


def test_k5_host_nonpositive_weight_draws_least(k5_lib):
    """A weight <= 0 has no multiplier (0) and the largest key: its draw is
    S64_MIN, below every real draw."""
    magic = vec.straw2_magic([0, -1, -0x10000, 1])
    assert list(magic[:3]) == [0, 0, 0] and magic[3] != 0
    assert k5_lib.k5_key(12345, -3, 7, 0, LN.ctypes.data) == 2**64 - 1
    assert k5_lib.k5_key(12345, -3, 7, int(magic[3]), LN.ctypes.data) <= 1 << 48


# -- maps that reach the loops' branches ----------------------------------------

def _unequal_row_map():
    """root -> 6 hosts of 5 OSDs; host 2's OSDs weigh unequally, the other
    rows are uniform."""
    cm = ref_builder.build_two_level_map(6, 5)
    host = cm.buckets[-4]
    host.item_weights = [0x10000, 0x8000, 0x30000, 0x1234, 0xFFFF]
    cm.buckets[-1].item_weights[2] = sum(host.item_weights)
    return cm


def _padded_map():
    """root -> 3 rows -> 4 racks -> 5 OSDs with buckets of unequal size at
    two levels: a row of 2 racks and racks of 1, 3 and 5 OSDs, so K5's
    tables carry padded columns of weight 0."""
    cm = ref_builder.build_hierarchy([3, 4, 5])
    root = cm.buckets[-1]
    row = cm.buckets[root.items[1]]
    del row.items[2:], row.item_weights[2:]
    for rack_id, keep in zip(cm.buckets[root.items[0]].items, (1, 3, 5, 2)):
        rack = cm.buckets[rack_id]
        del rack.items[keep:], rack.item_weights[keep:]
    return cm


NEW_MAPS = {
    "unequal row": (_unequal_row_map, {0: 3, 1: 4}),
    "padded columns": (_padded_map, {0: 3, 1: 3}),
    # 4 hosts under 4 slots: indep fills most lanes over several rounds;
    # firstn retries most replicas
    "4 hosts, 4 slots": (lambda: ref_builder.build_two_level_map(4, 3),
                         {0: 4, 1: 4}),
    # more slots than hosts: indep spends all 100 rounds, firstn its tries
    "4 hosts, 6 slots": (lambda: ref_builder.build_two_level_map(4, 3),
                         {0: 6, 1: 6}),
    # straw buckets, drawn as straw2; firstn's leaf r under other vary_r
    "straw buckets": (EXPRESSED["straw"], {0: 3, 1: 4}),
    "vary_r 0": (EXPRESSED["vary_r 0"], {0: 3, 1: 4}),
    "vary_r 2 by a rule step": (lambda: _vary_r(2, by_step=True),
                                {0: 3, 1: 4}),
}


@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
@pytest.mark.parametrize("name", list(NEW_MAPS))
def test_k5_host_new_branches(k5_host, name, rule):
    build, numreps = NEW_MAPS[name]
    cm = build()
    numrep = numreps[rule]
    weights = [0x10000] * cm.max_devices
    xs = seeds(96 if "6 slots" in name else 256, seed=37)
    vc = vec.VectorCrush(port_map(cm), rule, device="cpu")
    got = run_k5(k5_host, vc, xs, numrep, weights)
    np.testing.assert_array_equal(got, vc.map_pgs(xs, numrep, weights))
    np.testing.assert_array_equal(got, scalar_rows(cm, rule, xs, numrep,
                                                   weights))
    full = (got != vec.CRUSH_ITEM_NONE).all(axis=1)
    if name == "4 hosts, 4 slots":
        # a full row of 4 hosts in one round is 4!/4^4 < 10% of lanes
        assert full.mean() > 0.5
    if name == "4 hosts, 6 slots":
        assert not full.any() and (got != vec.CRUSH_ITEM_NONE).sum(1).min() == 4
    if name == "padded columns":
        assert vc.cm.weights[1].min() == 0 and vc.cm.weights[2].min() == 0


@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
def test_k5_host_no_choose_tries(k5_host, rule):
    """A rule whose choose tries are 0: the plain version runs no step, so
    every slot is a hole, and K5 takes no pass."""
    cm = ref_builder.build_two_level_map(4, 3)
    steps = cm.rules[rule].steps
    take = next(i for i, st in enumerate(steps) if st.op == CRUSH_RULE_TAKE)
    steps.insert(take, RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 0))
    xs = seeds(64, seed=41)
    weights = [0x10000] * cm.max_devices
    vc = vec.VectorCrush(port_map(cm), rule, device="cpu")
    assert vc.choose_tries == 0
    got = run_k5(k5_host, vc, xs, 3, weights)
    np.testing.assert_array_equal(got, vc.map_pgs(xs, 3, weights))
    assert (got == vec.CRUSH_ITEM_NONE).all()


def test_k5_time_counts_a_draw_loop():
    """``tools/k5_time.py`` finds the innermost loop with a draw's 45 XORs in
    ``cuobjdump -sass`` text, with hex or label branch targets, counts it by
    pipe and adds the routine it calls to the instructions a draw."""
    from ceph_tpu_torch.tools.k5_time import sass_counts
    lines = ["        /*0000*/                   S2R R0, SR_TID.X ;",
             "        /*0010*/                   IMAD.WIDE.U32 R4, R0, 0x4, R2 ;"]
    addr = 0x20
    for _ in range(45):
        lines.append(f"        /*{addr:04x}*/                   "
                     "LOP3.LUT R2, R3, R4, RZ, 0x3c, !PT ;")
        addr += 16
    lines += [f"        /*{addr:04x}*/                   IADD3 R5, -R5, R6, -R7 ;",
              f"        /*{addr + 16:04x}*/                   CALL.REL.NOINC 0x{addr + 64:x} ;",
              f"        /*{addr + 32:04x}*/              @!P0 BRA 0x20 ;",
              f"        /*{addr + 48:04x}*/                   EXIT ;",
              f"        /*{addr + 64:04x}*/                   IMAD R1, R2, R3, R4 ;",
              f"        /*{addr + 80:04x}*/                   RET.REL.NODEC R20 0x0 ;"]
    text = "\n".join(lines)
    for sass in (text, text.replace("@!P0 BRA 0x20", "@!P0 BRA `(.L_x_1)")
                 .replace("        /*0020*/", ".L_x_1:\n        /*0020*/")):
        got = sass_counts(sass)
        assert got["kernel"]["instructions"] == 53
        (loop,) = got["draw_loops"]
        assert loop["draws"] == 1 and loop["instructions"] == 48
        assert loop["by_pipe"] == {"alu": 46, "control": 2}
        assert loop["calls"][0]["instructions"] == 2
        assert loop["instructions_a_draw"] == 50


def test_placement_bound_is_the_slower_pipe():
    """``chip_smoke.py``'s K5 bound: a straw2 draw's 75 ALU-only operations
    at 64 lanes a clock a SM or all 140 at the 128 lanes a SM issues,
    whichever takes longer; all 140 on the ALU pipe is kept beside it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    lanes, numrep, mhz = 2_000_000, 3, 1980.0
    draws = lanes * numrep * sum(cs.PLACEMENT[2])       # 24 a descent
    per_ms = cs.SMS * mhz * 1e3
    alu, issue = draws * 75 / (64 * per_ms), draws * 140 / (128 * per_ms)
    got = cs.placement_bound(lanes, numrep, mhz)
    assert got["bound_ms"] == round(max(alu, issue), 4)
    assert (got["bound_by"], got["ops_by"]) == ("operations", "ALU pipe")
    assert got["int32_lanes_ms"] == round(draws * 140 / (64 * per_ms), 4)
    assert got["bound_ms"] < got["int32_lanes_ms"]
    assert got["bytes_ms"] == round(lanes * 16 / cs.HBM_BYTES_PER_S * 1e3, 4)
