"""The port's CRUSH (``ceph_tpu_torch.crush``) against ceph_tpu on the CPU.

The same maps (built with the reference's builders and carried across as
``crush_to_dict`` plus choose_args), weights and seeds go through the
reference and the port: crush_ln over all its inputs, the rjenkins hashes,
straw2 draws and is_out, and the plain bulk mapper lane by lane against the
reference's JAX ``VectorCrush``, its scalar ``crush_do_rule`` and the
native C oracle.  Exactness is the tolerance: integer results, zero
differing lanes.

The reference module ``ceph_tpu/crush/vectorized.py`` imports
``jax.experimental.enable_x64``, which jax 0.9 lacks; it is loaded here
under a private name with that attribute set only while it loads (the
scoped shim below), so ``import ceph_tpu.crush.vectorized`` still fails
everywhere else, as it does without this file.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import ceph_tpu.crush as ref_crush
from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush.hashes import crush_hash32_2_np, crush_hash32_3_np
from ceph_tpu.crush.ln import crush_ln_np
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    RuleStep)
from ceph_tpu.mon.osdmap import PoolSpec, crush_to_dict
from ceph_tpu.mon.pg_mapping import pool_pps as ref_pool_pps
from ceph_tpu import native
from ceph_tpu_torch.crush import state, vectorized as vec
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

REF_PATH = Path(ref_crush.__file__).parent / "vectorized.py"
# what the shim found before it first ran
BEFORE = {"enable_x64": hasattr(jax.experimental, "enable_x64"),
          "module": "ceph_tpu.crush.vectorized" in sys.modules}


def load_reference_vectorized():
    """The reference's vectorized module, loaded under a private name with
    ``jax.experimental.enable_x64`` set to ``jax.enable_x64`` only while it
    loads; neither the attribute nor the module stays behind."""
    had = hasattr(jax.experimental, "enable_x64")
    name = "ceph_tpu.crush._vectorized_ref"
    spec = importlib.util.spec_from_file_location(name, REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    if not had:
        jax.experimental.enable_x64 = jax.enable_x64
    sys.modules[name] = mod          # the module's dataclass looks it up
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
        if not had:
            del jax.experimental.enable_x64
    return mod


@pytest.fixture(scope="module")
def ref_vec():
    return load_reference_vectorized()


# -- the maps ---------------------------------------------------------------

def _reweights(rng, n: int) -> list[int]:
    """Every OSD in, a quarter at 0, 0x4000 or 0x8000."""
    w = [0x10000] * n
    for i in rng.choice(n, size=max(1, n // 4), replace=False):
        w[int(i)] = int(rng.choice([0, 0x4000, 0x8000]))
    return w


def _choose_args_map(rng):
    """A depth-3 map with a choose_args weight-set of 3 positions on every
    bucket and hash-id overrides on two of them."""
    cm = ref_builder.build_hierarchy([3, 4, 5])
    cm.create_choose_args(3)
    for bid, arg in cm.choose_args.items():
        arg["weight_set"] = [
            [int(w * rng.uniform(0.3, 1.7)) for w in row]
            for row in arg["weight_set"]]
    for bid in sorted(cm.choose_args)[:2]:
        b = cm.buckets[bid]
        cm.choose_args[bid]["ids"] = [int(i) - 7919 if i < 0 else int(i) + 5000
                                      for i in b.items]
    return cm


def ref_maps() -> dict:
    """name -> (reference CrushMap, osd weights, {rule: numrep})."""
    rng = np.random.default_rng(20261017)
    flat = ref_builder.build_flat_map(10)
    flat.add_rule(ref_builder.erasure_rule(1, -1, choose_type=0, leaf=False))
    two = ref_builder.build_two_level_map(
        6, 4, host_weights=[int(0x40000 * rng.uniform(0.5, 2.0))
                            for _ in range(6)])
    deep = ref_builder.build_hierarchy([2, 3, 2, 4])
    ca = _choose_args_map(rng)
    return {
        "flat10": (flat, _reweights(rng, 10), {0: 3, 1: 4}),
        "two6x4": (two, _reweights(rng, 24), {0: 3, 1: 4}),
        "depth4": (deep, _reweights(rng, 48), {0: 3, 1: 5}),
        "choose_args": (ca, _reweights(rng, 60), {0: 4, 1: 5}),
    }


MAPS = ref_maps()
CASES = [(name, rule) for name, (_, _, rules) in MAPS.items() for rule in rules]
CASE_IDS = [f"{name}-{'firstn' if rule == 0 else 'indep'}"
            for name, rule in CASES]


def port_map(cm):
    """The port's CrushMap for a reference one: its dict plus choose_args."""
    return state.crush_map_from_dict(crush_to_dict(cm), cm.choose_args)


def seeds(n: int = 512, seed: int = 7) -> np.ndarray:
    """pps seeds as a hashpspool pool gives them (values >= 2^31 included),
    then uniform uint32 values."""
    pool = PoolSpec(pool_id=3, name="p", pg_num=n // 2, pgp_num=n // 2)
    pps = ref_pool_pps(pool)
    assert (pps >= 2**31).any()
    rng = np.random.default_rng(seed)
    return np.concatenate([pps, rng.integers(0, 2**32, n - n // 2)])


def scalar_rows(cm, rule, xs, numrep, weights) -> np.ndarray:
    """The reference scalar engine's rows, NONE-padded to numrep."""
    rows = np.full((len(xs), numrep), CRUSH_ITEM_NONE, np.int64)
    for i, x in enumerate(xs):
        got = ref_crush.crush_do_rule(cm, rule, int(x), numrep, weights)
        rows[i, :len(got)] = got
    return rows


# -- the pieces -------------------------------------------------------------

def test_crush_ln_exhaustive():
    u = np.arange(65536)
    got = vec.crush_ln(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, crush_ln_np(u))


def test_hashes_match_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(-2**31, 2**32, 20000)
    b = rng.integers(-2**31, 2**32, 20000)
    c = rng.integers(-60, 2**32, 20000)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    u32 = [v.astype(np.int64) & 0xFFFFFFFF for v in (a, b, c)]
    np.testing.assert_array_equal(vec.hash32_2(ta, tb).numpy(),
                                  crush_hash32_2_np(u32[0], u32[1]))
    np.testing.assert_array_equal(vec.hash32_3(ta, tb, tc).numpy(),
                                  crush_hash32_3_np(*u32))


def test_straw2_draws_and_is_out_match_scalar():
    rng = np.random.default_rng(2)
    n, cols = 400, 7
    x = rng.integers(0, 2**32, n)
    ids = rng.integers(-40, 60, (n, cols))
    r = rng.integers(0, 300, n)
    w = rng.choice([0, 1, 3, 0x4000, 0x10000, 0x35555, 0x7FFFFFFF], (n, cols))
    got = vec.straw2_draws(*(torch.from_numpy(v) for v in (x, ids, r, w)))
    want = np.array([[ref_mapper._generate_exponential_distribution(
        0, int(x[i]), int(ids[i, j]), int(r[i]), int(w[i, j]))
        if w[i, j] else -(2**63) for j in range(cols)] for i in range(n)],
        np.int64)
    np.testing.assert_array_equal(got.numpy(), want)

    weights = rng.choice([0, 0x1000, 0x8000, 0xFFFF, 0x10000, 0x20000], 50)
    items = rng.integers(0, 50, n)
    out = vec.is_out(torch.from_numpy(weights), torch.from_numpy(items),
                     torch.from_numpy(x))
    want = [ref_mapper._is_out(None, list(map(int, weights)), int(i), int(v))
            for i, v in zip(items, x)]
    assert out.tolist() == want


# -- the bulk mapper --------------------------------------------------------

@pytest.mark.parametrize("name,rule", CASES, ids=CASE_IDS)
def test_plain_matches_reference_jax_vectorcrush(ref_vec, name, rule):
    cm, weights, rules = MAPS[name]
    xs = seeds()
    want = ref_vec.VectorCrush(cm, rule).map_pgs(xs, rules[rule], weights)
    got = vec.VectorCrush(port_map(cm), rule, device="cpu").map_pgs(
        xs, rules[rule], weights)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name,rule", CASES, ids=CASE_IDS)
def test_plain_matches_scalar_engine(name, rule):
    cm, weights, rules = MAPS[name]
    xs = seeds(384, seed=11)
    got = vec.VectorCrush(port_map(cm), rule, device="cpu").map_pgs(
        xs, rules[rule], weights)
    np.testing.assert_array_equal(got, scalar_rows(cm, rule, xs, rules[rule],
                                                   weights))


@pytest.mark.parametrize("name,rule", CASES, ids=CASE_IDS)
def test_plain_matches_native_oracle(name, rule):
    """The C oracle takes no choose_args: the choose_args map is mapped
    here by its hierarchy's own weights (``choose_args={}``)."""
    if not native.available():
        pytest.skip("the native C oracle is not built on this machine")
    cm, weights, rules = MAPS[name]
    numrep = rules[rule]
    xs = seeds(256, seed=13)
    got = vec.VectorCrush(port_map(cm), rule, choose_args={},
                          device="cpu").map_pgs(xs, numrep, weights)
    for i, x in enumerate(xs):
        want = native.crush_oracle_do_rule(cm, rule, int(x), numrep, weights)
        want = list(want) + [CRUSH_ITEM_NONE] * (numrep - len(want))
        assert list(got[i]) == want, (int(x), want, list(got[i]))


def test_short_weights_are_out_as_in_the_scalar_engine():
    """osd_weights shorter than max_devices: the port pads with 0 (out),
    as the scalar engine treats an item past the end."""
    cm, _, _ = MAPS["two6x4"]
    weights = [0x10000] * 20            # OSDs 20..23 past the end
    xs = seeds(256, seed=17)
    for rule, numrep in ((0, 3), (1, 4)):
        got = vec.VectorCrush(port_map(cm), rule, device="cpu").map_pgs(
            xs, numrep, weights)
        np.testing.assert_array_equal(
            got, scalar_rows(cm, rule, xs, numrep, weights))
        assert not np.isin(got, [20, 21, 22, 23]).any()


def test_kernel_map_words_layout():
    cm, _, _ = MAPS["choose_args"]
    vc = vec.VectorCrush(port_map(cm), 0, device="cpu")
    words = vc.map_words.numpy()
    c = vc.cm
    assert list(words[:8]) == [c.n_levels, c.n_levels - 1, 3, 1, 1,
                               vc.choose_tries, vc.recurse_tries, len(words)]
    for l in range(c.n_levels):
        n, o_ids, o_idx, o_m, b = words[8 + 5 * l: 13 + 5 * l]
        assert (b, n) == c.child_ids[l].shape
        np.testing.assert_array_equal(words[o_ids:o_ids + b * n],
                                      c.child_ids[l].ravel())
        np.testing.assert_array_equal(words[o_idx:o_idx + b * n],
                                      c.child_idx[l].ravel())
        # the weight-set's multipliers, int64 at an even offset
        assert o_m % 2 == 0 and o_m - (o_idx + b * n) in (0, 1)
        magic = words[o_m:o_m + 2 * 3 * b * n].astype("<i4").view("<u8")
        np.testing.assert_array_equal(magic, vec.straw2_magic(c.cw[l]).ravel())
        for wi, mi in zip(c.cw[l].ravel().tolist(), magic.tolist()):
            m, shift = mi & ((1 << 56) - 1), mi >> 56
            for gap in (1, wi - 1, wi, 2**48 - 1, 2**48):   # n // w at the ends
                assert (gap * m) >> (49 + shift) == gap // wi
    assert len(words) == o_m + 2 * 3 * b * n


def test_refused_shapes_raise_value_error_like_the_reference(ref_vec):
    """Shapes both refuse, with the reference's message: a list bucket, a
    bucket mixing osds and buckets, a plain choose of a bucket type.  The
    port's is ``Unexpressed``."""
    listed = ref_builder.build_two_level_map(3, 2)
    listed.buckets[-2].alg = CRUSH_BUCKET_LIST
    mixed = ref_builder.build_two_level_map(3, 2)
    mixed.buckets[-1].items.append(100)
    mixed.buckets[-1].item_weights.append(0x10000)
    flat = ref_builder.build_flat_map(4)
    flat.add_rule(ref_builder.replicated_rule(2, -1, choose_type=1,
                                              leaf=False))
    for cm, rule in ((listed, 0), (mixed, 0), (flat, 2)):
        with pytest.raises(ValueError) as want:
            ref_vec.VectorCrush(cm, rule)
        with pytest.raises(vec.Unexpressed) as got:
            vec.VectorCrush(port_map(cm), rule, device="cpu")
        assert str(got.value) == str(want.value)


def _straw_map():
    """Straw (not straw2) buckets without legacy straw values: the scalar
    engine draws them as straw2 on their own weights."""
    return ref_builder.build_hierarchy([3, 4, 5], alg=CRUSH_BUCKET_STRAW)


def _straw_under_choose_args():
    """A straw2 map with a 3-position weight-set whose rack buckets are
    straw: the scalar engine ignores choose_args for those."""
    cm = _choose_args_map(np.random.default_rng(5))
    for bid in sorted(cm.choose_args)[1:6]:
        cm.buckets[bid].alg = CRUSH_BUCKET_STRAW
    return cm


def _vary_r(vary_r: int, by_step: bool = False):
    cm = ref_builder.build_hierarchy([3, 4, 5])
    if by_step:
        for rule in cm.rules.values():
            rule.steps.insert(0, RuleStep(CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                                          vary_r))
    else:
        cm.tunables.chooseleaf_vary_r = vary_r
    return cm


# shapes beyond the reference's VectorCrush that the port expresses
EXPRESSED = {
    "straw": _straw_map,
    "straw under choose_args": _straw_under_choose_args,
    "vary_r 0": lambda: _vary_r(0),
    "vary_r 2": lambda: _vary_r(2),
    "vary_r 0 by a rule step": lambda: _vary_r(0, by_step=True),
}


@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
@pytest.mark.parametrize("name", list(EXPRESSED))
def test_plain_expresses_straw_and_vary_r_like_the_scalar_engine(name, rule):
    """Straw buckets and any chooseleaf_vary_r, held lane by lane against
    the reference's scalar engine with a quarter of the OSDs reweighted (so
    the leaf retries run).  firstn's leaf draws depend on vary_r: the rows
    differ from jewel's on some lanes."""
    cm = EXPRESSED[name]()
    rng = np.random.default_rng(43)
    weights = _reweights(rng, cm.max_devices)
    xs = seeds(384, seed=47)
    numrep = 3 if rule == 0 else 4
    vc = vec.VectorCrush(port_map(cm), rule, device="cpu")
    got = vc.map_pgs(xs, numrep, weights)
    np.testing.assert_array_equal(got, scalar_rows(cm, rule, xs, numrep,
                                                   weights))
    if name.startswith("vary_r") and rule == 0:
        jewel = vec.VectorCrush(port_map(_vary_r(1)), 0, device="cpu")
        assert (got != jewel.map_pgs(xs, numrep, weights)).any()


def _unexpressed(kind: str):
    cm = ref_builder.build_hierarchy([3, 4, 5])
    steps = cm.rules[0].steps
    if kind == "legacy straw values":
        b = cm.buckets[-2]
        b.alg = CRUSH_BUCKET_STRAW
        b.straws = [0x10000] * b.size
    elif kind == "chooseleaf_stable 0":
        cm.tunables.chooseleaf_stable = 0
    elif kind == "local retries":
        steps.insert(0, RuleStep(CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, 2))
    elif kind == "replica count":
        steps[1].arg1 = 2
    elif kind == "two choose steps":
        steps.insert(1, RuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 0, 3))
    return cm


@pytest.mark.parametrize("kind", ["legacy straw values", "chooseleaf_stable 0",
                                  "local retries", "replica count",
                                  "two choose steps"])
def test_unexpressed_shapes_are_refused_and_swept(kind):
    """Shapes the bulk mapper does not express raise ``Unexpressed`` before
    any launch, and ``bulk_crush`` sweeps them with the scalar engine."""
    from ceph_tpu_torch.mon import pg_mapping as pm

    cm = _unexpressed(kind)
    pcm = port_map(cm)
    if kind == "legacy straw values":
        pcm.buckets[-2].straws = list(cm.buckets[-2].straws)
    with pytest.raises(vec.Unexpressed):
        vec.VectorCrush(pcm, 0, device="cpu")
    weights = [0x10000] * cm.max_devices
    xs = seeds(128, seed=53)
    rows, used = pm.bulk_crush(pcm, 0, xs, 3, weights, min_lanes=1,
                               device="cpu")
    assert not used
    np.testing.assert_array_equal(rows, scalar_rows(cm, 0, xs, 3, weights))


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cm, _, _ = MAPS["flat10"]
    with pytest.raises(RuntimeError, match="CUDA"):
        vec.VectorCrush(port_map(cm), 0)


def test_map_device_takes_int32_seeds_on_its_device():
    cm, weights, _ = MAPS["flat10"]
    vc = vec.VectorCrush(port_map(cm), 0, device="cpu")
    with pytest.raises(TypeError):
        vc.map_device(torch.zeros(4, dtype=torch.int64), 3, weights)
    empty = vc.map_device(torch.zeros(0, dtype=torch.int32), 3, weights)
    assert empty.shape == (0, 3)
    launches = vec.LAUNCHES["crush_map_rule"]
    vc.map_device(torch.arange(16, dtype=torch.int32), 3, weights)
    assert vec.LAUNCHES["crush_map_rule"] == launches   # CPU: no kernel


def test_state_round_trip():
    cm, _, _ = MAPS["choose_args"]
    pm = port_map(cm)
    assert state.crush_to_dict(pm) == crush_to_dict(cm)
    assert pm.choose_args == cm.choose_args
    assert type(pm.buckets[-1]).__module__ == "ceph_tpu_torch.crush.types"


def test_shim_leaves_no_trace(ref_vec):
    assert ref_vec.VectorCrush is not None
    assert hasattr(jax.experimental, "enable_x64") == BEFORE["enable_x64"]
    assert "ceph_tpu.crush._vectorized_ref" not in sys.modules
    assert ("ceph_tpu.crush.vectorized" in sys.modules) == BEFORE["module"]
    if not BEFORE["enable_x64"]:
        with pytest.raises(ImportError):
            import ceph_tpu.crush.vectorized  # noqa: F401
