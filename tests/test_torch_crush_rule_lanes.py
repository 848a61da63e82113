"""Kernel K6 (``crush_rule_lanes``) built as host C++ and held lane by lane.

``csrc/crush_rule.cu`` compiles without ``__CUDACC__`` when the includer
supplies the CUDA built-ins it uses.  The harness below runs a small grid's
threads one after another (a thread's lanes are independent: no barrier, no
shared memory), so the grid-stride walk and every decision of the rule
interpreter run as on the card, against the port's scalar ``crush_do_rule``
and the reference's, on maps written as ``crushtool`` text and compiled by
both packages' compilers: every shape K5 refuses (buckets mixing osds and
buckets; uniform, list, tree and legacy straw buckets; pre-jewel tunables
with local and fallback retries; a chooseleaf above the hosts; a plain
choose of a bucket type; several take and choose steps, choose steps with a
replica count and the ``set_*`` steps), firstn and indep, choose_args,
reweights 0 / 0x4000 / 0x8000 and seeds >= 2^31.  A uniform bucket visited
more than once within one lane (firstn's retries, indep's rounds) checks
that K6's stateless permutation walk gives what the scalar engine's
per-bucket permutation state gives.  Exactness is the tolerance: integer
rows, zero differing lanes.  The card runs K6 in ``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess
from collections import Counter

import numpy as np
import pytest
import torch

from ceph_tpu.crush import crush_do_rule as ref_crush_do_rule
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu_torch.crush import mapper, rule_lanes
from ceph_tpu_torch.crush import vectorized as vec
from ceph_tpu_torch.crush.types import (
    CRUSH_BUCKET_STRAW, CRUSH_ITEM_NONE, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT, CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R, CRUSH_RULE_TAKE)
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.tools import crushtool
from test_torch_crush import seeds

HARNESS = r"""
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
inline int __clz(int x) { return x ? __builtin_clz(static_cast<unsigned>(x)) : 32; }
#include "crush_rule.cu"
// a grid of `blocks` blocks of `threads` threads, one thread after another
extern "C" __attribute__((visibility("default")))
void k6_host(const int* xs, long long n, int numrep, const int* osd_w, int n_w,
             const long long* map, const long long* ln, int* out, int blocks, int threads) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int bx = 0; bx < blocks; ++bx)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = bx;
      threadIdx.x = t;
      crush_rule_lanes_kernel(xs, n, numrep, osd_w, n_w, map, ln, out);
    }
}
extern "C" __attribute__((visibility("default"))) int k6_max_result() { return kMaxResult; }
"""

# the harness's grid: lanes walk grid-stride over 2 blocks of 16 threads
BLOCKS, THREADS = 2, 16
LN = vec.ln_words(torch.device("cpu")).numpy()


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K6's source for the CPU")
    tmp = tmp_path_factory.mktemp("k6_host")
    src = tmp / "k6_host.cpp"
    src.write_text(HARNESS)
    lib = tmp / "libk6_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-fvisibility=hidden", "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   text=True)
    dll = ctypes.CDLL(str(lib))
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.k6_host.argtypes = [v, ll, i, v, i, v, v, v, i, i]
    dll.k6_host.restype = None
    dll.k6_max_result.restype = i
    return dll


def run_k6(lib, cm, rule: int, xs, numrep: int, weights) -> np.ndarray:
    """K6's rows for numpy seeds, with the wrapper's seeds and map words."""
    x = (np.asarray(xs, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    words = rule_lanes.flatten_rule(cm, rule)
    w = np.asarray(weights, np.int32)
    out = np.full((len(x), numrep), -5, np.int32)
    lib.k6_host(x.ctypes.data, len(x), numrep, w.ctypes.data if len(w) else None,
                len(w), words.ctypes.data, LN.ctypes.data, out.ctypes.data,
                BLOCKS, THREADS)
    return out


def scalar(engine, cm, rule, xs, numrep, weights) -> np.ndarray:
    rows = np.full((len(xs), numrep), CRUSH_ITEM_NONE, np.int32)
    for i, x in enumerate((np.asarray(xs, np.int64) & 0xFFFFFFFF).tolist()):
        got = engine(cm, rule, int(x), numrep, list(weights))[:numrep]
        rows[i, :len(got)] = got
    return rows


# -- the maps, as crushtool text ------------------------------------------------

TYPES = ["osd", "host", "rack", "row"]


def hierarchy_text(fanouts, algs, rules: str, seed: int,
                   tunables: dict | None = None) -> str:
    """root -> ... -> osds, ``fanouts`` from the top, ``algs[l]`` the bucket
    kind at level l (0 the root); osd weights in [0.5, 2], a bucket's item
    weight its child's total."""
    rng = np.random.default_rng(seed)
    depth = len(fanouts)
    n_osd = int(np.prod(fanouts))
    osd_w = np.round(rng.uniform(0.5, 2.0, n_osd), 2)
    lines = [f"tunable {k} {v}" for k, v in (tunables or {}).items()]
    lines += [f"device {i} osd.{i}" for i in range(n_osd)]
    lines += [f"type {t} {TYPES[t]}" for t in range(depth)] + ["type 10 root"]
    next_id = [-2]
    # level depth-1 buckets hold osds; build bottom-up
    children = [(f"osd.{i}", float(osd_w[i])) for i in range(n_osd)]
    for level in range(depth - 1, 0, -1):
        fan = fanouts[level]
        tname = TYPES[depth - level]
        made = []
        for j in range(len(children) // fan):
            kids = children[j * fan:(j + 1) * fan]
            name = f"{tname}{j}"
            body = "".join(f" item {n} weight {w:.5f}" for n, w in kids)
            lines.append(f"{tname} {name} {{ id {next_id[0]} alg {algs[level]}"
                         f"{body} }}")
            next_id[0] -= 1
            made.append((name, sum(w for _, w in kids)))
        children = made
    body = "".join(f" item {n} weight {w:.5f}" for n, w in children)
    lines.append(f"root default {{ id -1 alg {algs[0]}{body} }}")
    return "\n".join(lines) + "\n" + rules


def rule(rid: int, *steps: str, kind: str = "replicated") -> str:
    body = " ".join(f"step {s}" for s in ("take default", *steps, "emit"))
    return f"rule r{rid} {{ id {rid} type {kind} {body} }}\n"


def both(text: str, tweak=None):
    """The port's and the reference's CrushMap of ``text``, each passed
    through ``tweak(map)``."""
    port = crushtool.compile_text(text)[0]
    ref = ref_crushtool.compile_text(text)[0]
    if tweak is not None:
        tweak(port)
        tweak(ref)
    return port, ref


LEAF_RULES = (rule(0, "chooseleaf firstn 0 type host")
              + rule(1, "chooseleaf indep 0 type host", kind="erasure"))
ARGONAUT = {"choose_local_tries": 2, "choose_local_fallback_tries": 5,
            "choose_total_tries": 19, "chooseleaf_descend_once": 0,
            "chooseleaf_vary_r": 0, "chooseleaf_stable": 0}
# pre-argonaut local retries alone: a collision retries the same bucket
LOCAL_TRIES = {"choose_local_tries": 2, "choose_local_fallback_tries": 0,
               "chooseleaf_descend_once": 0, "chooseleaf_stable": 0}
BOBTAIL = {"choose_local_tries": 0, "choose_local_fallback_tries": 0,
           "chooseleaf_descend_once": 1, "chooseleaf_vary_r": 0,
           "chooseleaf_stable": 0}


def _mixed(cm):
    """host0 also holds host1 (an osd and a bucket side by side), and the
    root an osd of its own."""
    host0 = cm.buckets[cm.name_to_id("host0")]
    host0.items.append(cm.name_to_id("host1"))
    host0.item_weights.append(0x30000)
    root = cm.buckets[-1]
    root.items.append(3)
    root.item_weights.append(0x10000)


def _legacy_straw(cm):
    """Every bucket a straw bucket carrying legacy straw values."""
    rng = np.random.default_rng(77)
    for b in cm.buckets.values():
        b.alg = CRUSH_BUCKET_STRAW
        b.straws = [int(v) for v in rng.integers(0x8000, 0x30000, b.size)]


def _choose_args(cm):
    """A weight-set of 3 positions on every bucket, hash ids on the root."""
    rng = np.random.default_rng(78)
    cm.create_choose_args(3)
    for arg in cm.choose_args.values():
        arg["weight_set"] = [[int(w * rng.uniform(0.3, 1.7)) for w in row]
                             for row in arg["weight_set"]]
    root = cm.buckets[-1]
    cm.choose_args[-1]["ids"] = [i - 7919 for i in root.items]


def _step(cm, op: int, arg1: int = 0, arg2: int = 0):
    """A rule step of ``cm``'s own package."""
    return type(cm.rules[0].steps[0])(op, arg1, arg2)


def _set_steps(cm):
    """Rule 0's and 1's set_* steps ahead of their choose step."""
    for rid, vals in ((0, (3, 2, 1, 4, 2, 0)), (1, (5, 0, 2, 0, 1, 1))):
        r = cm.rules[rid]
        ops = (CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
               CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
               CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
               CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
               CRUSH_RULE_SET_CHOOSELEAF_STABLE)
        r.steps[1:1] = [_step(cm, op, v) for op, v in zip(ops, vals)]


def _two_takes(cm):
    """Rules 0 and 1 first take row 0's first rack and chooseleaf 1 host
    there (firstn, indep), emit, then take the root for their own step."""
    rack = cm.name_to_id("rack0")
    for rid, op in ((0, CRUSH_RULE_CHOOSELEAF_FIRSTN),
                    (1, CRUSH_RULE_CHOOSELEAF_INDEP)):
        cm.rules[rid].steps[:0] = [_step(cm, CRUSH_RULE_TAKE, rack),
                                   _step(cm, op, 1, 1),
                                   _step(cm, CRUSH_RULE_EMIT)]


SHAPES = {
    # name: (fanouts, algs, rules, tunables, tweak, {rule: numrep})
    "mixed": ((4, 3, 5), ("straw2",) * 3, LEAF_RULES, None, _mixed,
              {0: 3, 1: 4}),
    "uniform": ((3, 4, 4), ("uniform",) * 3, LEAF_RULES, None, None,
                {0: 3, 1: 4}),
    "list": ((3, 4, 4), ("list",) * 3, LEAF_RULES, None, None, {0: 3, 1: 5}),
    "tree": ((3, 5, 3), ("tree",) * 3, LEAF_RULES, None, None, {0: 3, 1: 5}),
    "legacy straw": ((3, 4, 4), ("straw",) * 3, LEAF_RULES, None,
                     _legacy_straw, {0: 3, 1: 5}),
    "straw without straws": ((3, 4, 4), ("straw", "straw2", "straw"),
                             LEAF_RULES, BOBTAIL, None, {0: 3, 1: 5}),
    "kinds mixed by level": ((3, 4, 4), ("tree", "list", "uniform"),
                             LEAF_RULES, None, None, {0: 3, 1: 5}),
    "argonaut": ((3, 4, 4), ("straw2",) * 3, LEAF_RULES, ARGONAUT, None,
                 {0: 3, 1: 5}),
    "argonaut uniform": ((3, 4, 4), ("uniform", "straw2", "uniform"),
                         LEAF_RULES, ARGONAUT, None, {0: 4, 1: 6}),
    "local tries": ((3, 4, 4), ("straw2", "uniform", "list"), LEAF_RULES,
                    LOCAL_TRIES, None, {0: 6, 1: 6}),
    "bobtail choose_args": ((3, 4, 4), ("straw2",) * 3, LEAF_RULES, BOBTAIL,
                            _choose_args, {0: 4, 1: 5}),
    "chooseleaf above hosts": (
        (2, 3, 3, 3), ("straw2",) * 4,
        rule(0, "chooseleaf firstn 0 type rack")
        + rule(1, "chooseleaf indep 0 type rack", kind="erasure"),
        None, None, {0: 3, 1: 4}),
    "plain choose of a bucket type": (
        (3, 4, 4), ("straw2", "list", "straw2"),
        rule(0, "choose firstn 0 type host")
        + rule(1, "choose indep 0 type rack", kind="erasure"),
        None, None, {0: 3, 1: 3}),
    "rack then host": (
        (2, 3, 3, 3), ("straw2", "uniform", "straw2", "straw2"),
        rule(0, "choose firstn 2 type rack", "chooseleaf firstn 2 type host")
        + rule(1, "choose indep 2 type rack",
               "chooseleaf indep 2 type host", kind="erasure")
        + rule(2, "choose firstn -1 type host", "choose firstn 1 type osd"),
        None, None, {0: 4, 1: 4, 2: 5}),
    "set steps": ((3, 4, 4), ("straw2", "uniform", "straw2"), LEAF_RULES,
                  None, _set_steps, {0: 3, 1: 5}),
    "two takes": ((2, 3, 3, 3), ("straw2",) * 4,
                  rule(0, "chooseleaf firstn -1 type rack")
                  + rule(1, "chooseleaf indep -1 type rack", kind="erasure"),
                  None, _two_takes, {0: 4, 1: 4}),
}
CASES = [(name, r) for name, spec in SHAPES.items() for r in spec[5]]


def shape_maps(name: str):
    fanouts, algs, rules, tunables, tweak, _ = SHAPES[name]
    text = hierarchy_text(fanouts, algs, rules, seed=len(name),
                          tunables=tunables)
    return both(text, tweak)


def reweights(cm, seed: int) -> list[int]:
    """Every OSD in, a quarter at 0, 0x4000 or 0x8000; one short of the
    map's devices (the last OSD past the weights' end is out)."""
    rng = np.random.default_rng(seed)
    n = cm.max_devices
    w = [0x10000] * (n - 1)
    for i in rng.choice(n - 1, size=max(1, n // 4), replace=False):
        w[int(i)] = int(rng.choice([0, 0x4000, 0x8000]))
    return w


@pytest.mark.parametrize("name,rule_id", CASES,
                         ids=[f"{n}-{r}" for n, r in CASES])
def test_k6_host_matches_the_scalar_engines(k6, name, rule_id):
    port, ref = shape_maps(name)
    numrep = SHAPES[name][5][rule_id]
    xs = seeds(256, seed=41 + rule_id)
    w = reweights(port, seed=len(name))
    got = run_k6(k6, port, rule_id, xs, numrep, w)
    want = scalar(mapper.crush_do_rule, port, rule_id, xs, numrep, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, scalar(ref_crush_do_rule, ref, rule_id, xs, numrep, w))
    assert (got != CRUSH_ITEM_NONE).any()


@pytest.mark.parametrize("name,rule_id", [("uniform", 0), ("uniform", 1),
                                          ("argonaut uniform", 0),
                                          ("argonaut uniform", 1)])
def test_a_uniform_bucket_revisited_within_a_lane(k6, monkeypatch, name,
                                                  rule_id):
    """Lanes that draw one uniform bucket at several r (firstn's retries,
    indep's rounds, argonaut's local fallback) agree with the scalar
    engine, whose permutation is state kept per bucket across the visits;
    the seeds include such lanes."""
    port, _ = shape_maps(name)
    numrep = SHAPES[name][5][rule_id]
    w = [0x10000 if i % 3 else 0x4000 for i in range(port.max_devices)]
    xs = seeds(256, seed=43)
    visits = Counter()
    real = mapper._bucket_perm_choose

    def counting(bucket, work, x, r):
        visits[(x, bucket.id)] += 1
        return real(bucket, work, x, r)
    monkeypatch.setattr(mapper, "_bucket_perm_choose", counting)
    want = scalar(mapper.crush_do_rule, port, rule_id, xs, numrep, w)
    revisited = sum(1 for n in visits.values() if n > 1)
    assert revisited > 32, revisited
    np.testing.assert_array_equal(run_k6(k6, port, rule_id, xs, numrep, w),
                                  want)


def test_k6_host_at_the_largest_result_max(k6):
    """indep across 32 slots (the working vectors' size) on a map of 48
    OSDs; the wrapper refuses 33."""
    port, ref = shape_maps("argonaut")
    assert k6.k6_max_result() == rule_lanes.MAX_RESULT == 32
    xs = seeds(64, seed=47)
    w = [0x10000] * port.max_devices
    got = run_k6(k6, port, 1, xs, 32, w)
    np.testing.assert_array_equal(
        got, scalar(ref_crush_do_rule, ref, 1, xs, 32, w))
    rl = rule_lanes.RuleLanes(port, 1, device="cpu")
    with pytest.raises(ValueError, match="at most 32"):
        rl.map_device(torch.zeros(4, dtype=torch.int32), 33, w)


def test_plain_version_is_the_scalar_sweep():
    """``RuleLanes.map_device`` on CPU seeds is ``plain_rows``: the scalar
    engine over every lane."""
    port, ref = shape_maps("tree")
    xs = seeds(96, seed=53)
    w = reweights(port, seed=5)
    rl = rule_lanes.RuleLanes(port, 1, device="cpu")
    got = rl.map_device(vec.seed_tensor(xs, "cpu"), 5, w)
    assert got.dtype == torch.int32 and got.shape == (96, 5)
    np.testing.assert_array_equal(
        got.numpy(), scalar(ref_crush_do_rule, ref, 1, xs, 5, w))
    assert rule_lanes.LAUNCHES["crush_rule_lanes"] == 0


def test_flatten_layout():
    """Header, slot table by -1 - id, a record a bucket, steps last."""
    port, _ = shape_maps("list")
    words = rule_lanes.flatten_rule(port, 0)
    assert words.dtype == np.int64 and words[11] == len(words)
    max_dev, slots, slot_off, n_steps, steps_off = words[:5]
    assert max_dev == port.max_devices and slots == len(port.buckets)
    assert words[5] == port.tunables.choose_total_tries + 1
    for bid, b in port.buckets.items():
        rec = words[slot_off - 1 - bid]
        assert list(words[rec:rec + 4]) == [bid, b.type, b.alg, b.size]
        assert list(words[words[rec + 4]:words[rec + 4] + b.size]) == b.items
        assert list(words[words[rec + 5]:words[rec + 5] + b.size]) == \
            b.item_weights
    assert list(words[steps_off:steps_off + 3 * n_steps]) == [
        v for s in port.rules[0].steps for v in (s.op, s.arg1, s.arg2)]


def test_flatten_refusals():
    """A dangling bucket reference, a negative tunable and choose_args that
    do not match their bucket raise ValueError; a missing rule KeyError."""
    port, _ = shape_maps("mixed")
    port.buckets[-1].items[0] = -77
    with pytest.raises(ValueError, match="dangling"):
        rule_lanes.flatten_rule(port, 0)
    port, _ = shape_maps("argonaut")
    port.tunables.chooseleaf_vary_r = -1
    with pytest.raises(ValueError, match="negative"):
        rule_lanes.flatten_rule(port, 0)
    port, _ = shape_maps("bobtail choose_args")
    port.choose_args[-1]["weight_set"][0].pop()
    with pytest.raises(ValueError, match="choose_args"):
        rule_lanes.flatten_rule(port, 0)
    with pytest.raises(KeyError):
        rule_lanes.flatten_rule(port, 9)


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = shape_maps("mixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        rule_lanes.RuleLanes(port, 0)
