"""The port's OSDMap and epoch placement table (``ceph_tpu_torch.mon``)
against ceph_tpu on the CPU.

The same seeded maps -- depths 1-4, down/out/reweighted OSDs, an osdmap
shorter than the CRUSH map's devices, upmaps with dangling or present
targets, pg_temp empty, short, long, with dead members and all dead, EC and
replicated pools, a pool whose id is a prefix of another's -- are built with
the reference and carried across by ``to_dict()`` / ``from_dict()``.  The
port's ``PGMapping``, built with ``device="cpu"`` through the scalar sweep
and through the bulk mapper (K5's plain version), must equal the reference's
``PGMapping.build(fused="never")`` and ``_pg_to_up_acting_scalar`` entry for
entry, raw ps past pg_num included, and ``delta`` the reference's list.
Exactness is the tolerance.  (The reference's fused build does not import
under jax 0.9; its JAX ``VectorCrush`` is reached through
``test_torch_crush``'s scoped loader.)
"""

import math
import random

import numpy as np
import pytest
import torch

from ceph_tpu.crush import crush_do_rule as ref_crush_do_rule
from ceph_tpu.crush.builder import build_hierarchy
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_STRAW, CRUSH_ITEM_NONE, CRUSH_RULE_SET_CHOOSE_TRIES,
    RuleStep)
from ceph_tpu.mon.osdmap import (
    POOL_TYPE_ERASURE, Incremental as RefIncremental, OSDMap as RefOSDMap,
    OsdInfo, PoolSpec, crush_to_dict as ref_crush_to_dict)
from ceph_tpu.mon.pg_mapping import PGMapping as RefPGMapping
from ceph_tpu.mon.pg_mapping import pool_pps as ref_pool_pps
from ceph_tpu_torch.crush import rule_lanes
from ceph_tpu_torch.crush.vectorized import Unexpressed, VectorCrush, seed_tensor
from ceph_tpu_torch.mon import pg_mapping as pm_mod
from ceph_tpu_torch.mon.osdmap import Incremental, OSDMap
from ceph_tpu_torch.mon.pg_mapping import PGMapping
from test_torch_crush import load_reference_vectorized

DEPTHS = {1: [6], 2: [4, 4], 3: [3, 3, 4], 4: [2, 3, 2, 3]}


def make_ref_map(seed: int, fanouts, pg_num: int = 16, missing: int = 0,
                 extra_pool: bool = False) -> RefOSDMap:
    """A reference OSDMap: ``fanouts``' hierarchy with random down, out and
    reweighted OSDs (the last ``missing`` OSDs of the CRUSH map absent from
    the osdmap, so its weights are shorter than max_devices), a replicated
    pool 1 (size 3), an EC pool 2 (rule 1, size 4, or one less than the
    hosts: a slot no host can fill costs the plain mapper all its rounds)
    and, with
    ``extra_pool``, a replicated pool 11 whose keys start like pool 1's;
    upmap items (random, dangling targets, targets already in the row) and
    pg_temp (empty, short, long, with dead members, all dead), plus keys
    that do not parse and pgs past pg_num."""
    rnd = random.Random(seed)
    n = math.prod(fanouts)
    m = RefOSDMap()
    m.epoch = 1
    m.crush = build_hierarchy(fanouts)
    known = n - missing
    m.max_osd = known
    for o in range(known):
        m.osds[o] = OsdInfo(
            up=rnd.random() >= 0.15, in_cluster=rnd.random() >= 0.1,
            weight=rnd.choice([0x10000, 0x10000, 0x8000, 0x4000]))
    m.pools[1] = PoolSpec(pool_id=1, name="rep", size=3, pg_num=pg_num,
                          pgp_num=pg_num)
    hosts = math.prod(fanouts[:-1]) if len(fanouts) > 1 else 5
    m.pools[2] = PoolSpec(pool_id=2, name="ec", type=POOL_TYPE_ERASURE,
                          size=min(4, hosts - 1), min_size=2, pg_num=pg_num,
                          pgp_num=pg_num, crush_rule=1)
    if extra_pool:
        m.pools[11] = PoolSpec(pool_id=11, name="rep11", size=2, pg_num=8,
                               pgp_num=8)
    m.pool_names = {p.name: pid for pid, p in m.pools.items()}
    every = list(range(known))
    dead = [o for o in every if not m.osds[o].up] or [n + 5]
    weights = m.osd_weights()
    for pid, pool in m.pools.items():
        for _ in range(rnd.randrange(2, 5)):
            pg = rnd.randrange(pool.pg_num)
            m.pg_upmap_items[f"{pid}.{pg:x}"] = rnd.choice([
                [(rnd.choice(every), rnd.choice(every))],
                [(rnd.choice(every), n + 3)],
                [(rnd.choice(every), rnd.choice(every)),
                 (rnd.choice(every), rnd.choice(every))]])
        # one pg's items read its raw row: a target already present (skipped)
        # and a replacement of its first entry
        pg = rnd.randrange(pool.pg_num)
        raw = ref_crush_do_rule(m.crush, pool.crush_rule,
                                pool.raw_pg_to_pps(pg), pool.size, weights)
        if len(raw) >= 2:
            m.pg_upmap_items[f"{pid}.{pg:x}"] = [
                (raw[0], raw[1]), (raw[0], rnd.choice(every))]
        for _ in range(rnd.randrange(3, 6)):
            pg = rnd.randrange(pool.pg_num)
            m.pg_temp[f"{pid}.{pg:x}"] = rnd.choice([
                [], rnd.sample(every, 2),
                rnd.sample(every, min(known, pool.size + 2)),
                [rnd.choice(every), -1, rnd.choice(every)],
                dead[:3]])
        m.pg_temp[f"{pid}.zz"] = [0]
        m.pg_upmap_items[f"{pid}.{pool.pg_num + 3:x}"] = [(0, 1)]
    return m


def port_of(ref: RefOSDMap, device="cpu") -> OSDMap:
    return OSDMap.from_dict(ref.to_dict(), device=device)


def assert_same_table(ref: RefOSDMap, ref_pm, pm, scalar: bool = True):
    """Entry for entry over raw ps in [0, 2 pg_num + 3): the port's table ==
    the reference's table (== the reference's scalar pipeline)."""
    for pid, pool in ref.pools.items():
        for ps in range(2 * pool.pg_num + 3):
            want = ref_pm.lookup(pid, ps)
            assert pm.lookup(pid, ps) == want, (pid, ps)
            if scalar:
                assert ref._pg_to_up_acting_scalar(pid, ps) == want, (pid, ps)


def build_both(ref: RefOSDMap, fused: str):
    """(reference table, fused="never"; the port's table on the CPU)."""
    m = port_of(ref)
    pm = PGMapping.build(m, fused=fused, min_lanes=1)
    return RefPGMapping.build(ref, fused="never"), m, pm


# -- the table against the reference ----------------------------------------

@pytest.mark.parametrize("fused", ["never", "auto"], ids=["scalar", "bulk"])
@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_table_equals_reference_and_scalar(depth, fused):
    ref = make_ref_map(depth, DEPTHS[depth], extra_pool=depth == 2)
    ref_pm, _, pm = build_both(ref, fused)
    assert_same_table(ref, ref_pm, pm)
    # a depth-1 map's chooseleaf maps nothing: NONE rows, no mapper
    bulk = fused == "auto" and depth > 1
    assert (pm.fused_pools, pm.scalar_pools) == (
        (len(ref.pools), 0) if bulk else (0, len(ref.pools)))


@pytest.mark.parametrize("seed", range(3))
def test_random_maps_equal_reference(seed):
    rnd = random.Random(1000 + seed)
    ref = make_ref_map(1000 + seed, DEPTHS[rnd.choice([2, 3, 4])],
                       pg_num=rnd.choice([12, 16, 24]))
    ref_pm, _, pm = build_both(ref, "always")
    assert_same_table(ref, ref_pm, pm)


def test_osdmap_shorter_than_max_devices():
    """Weights shorter than the CRUSH map's devices: the bulk mapper pads
    them with 0 (out), the live filter's bound is len(weights) + 1."""
    ref = make_ref_map(7, [4, 4], missing=5)
    assert len(ref.osd_weights()) < ref.crush.max_devices
    for fused in ("never", "always"):
        ref_pm, _, pm = build_both(ref, fused)
        assert_same_table(ref, ref_pm, pm)


def test_crush_holes_are_normalized():
    """Slots CRUSH cannot fill (one host of three out): CRUSH_ITEM_NONE in
    the raw rows, -1 in an EC pool's up set, dropped from a replicated
    one's.  Fewer tries than the rules' (a slot no host can fill costs the
    plain mapper all of them)."""
    ref = make_ref_map(8, [3, 2], pg_num=8)
    ref.pools[2].size = 3
    ref.crush.tunables.choose_total_tries = 8
    ref.crush.rules[1].steps[1] = RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 8)
    for o in range(6):
        ref.osds[o].up, ref.osds[o].in_cluster = True, o < 4
    ref.pg_temp.clear()
    ref.pg_upmap_items.clear()
    ref.invalidate_placement_cache()
    ref_pm, _, pm = build_both(ref, "always")
    assert_same_table(ref, ref_pm, pm)
    up, up_len, _, _ = pm.tables()[2]
    assert (up == -1).any(axis=1).all() and (up_len == 3).all()
    assert (pm.tables()[1][1] <= 2).all()


def test_overrides_of_another_pool_and_odd_keys():
    """"11.x" is not pool 1's; a key that does not parse, a pg past pg_num
    and a non-canonical key ("1.05") are treated as the reference's table
    treats them; two keys of one pg apply in the dict's order."""
    ref = make_ref_map(3, [4, 4], extra_pool=True)
    ref.pg_temp.update({"11.3": [0, 1], "1.3": [5, 6, 7, 8], "1.03": [2],
                        "11.": [1], "1": [1]})
    ref.pg_upmap_items.update({"11.2": [(0, 9)], "1.05": [(4, 5)],
                               "1.5": [(2, 3)], "2.-1": [(0, 1)]})
    ref.invalidate_placement_cache()
    ref_pm, _, pm = build_both(ref, "always")
    assert_same_table(ref, ref_pm, pm, scalar=False)


def test_table_arrays():
    """int32 arrays padded with -1; acting as wide as the longest temp."""
    ref = make_ref_map(11, [4, 4], pg_num=16)
    ref.pg_temp["1.4"] = [0, 1, 2, 3, 4, 5, 6]
    for o in range(7):
        ref.osds[o].up = True
    pm = PGMapping.build(port_of(ref), fused="always")
    up, up_len, acting, acting_len = pm.tables()[1]
    assert all(a.dtype == np.int32 for a in (up, up_len, acting, acting_len))
    assert up.shape == (16, 3) and acting.shape == (16, 7)
    assert acting_len[4] == 7 and list(acting[4]) == [0, 1, 2, 3, 4, 5, 6]
    cols = np.arange(up.shape[1])
    assert (up[cols >= up_len[:, None]] == -1).all()
    ec_up, ec_len, _, _ = pm.tables()[2]
    assert (ec_len == 3).all() and ec_up.shape == (16, 3)


@pytest.mark.parametrize("rule,numrep", [(0, 3), (1, 5)],
                         ids=["firstn", "indep"])
def test_device_rows_match_reference_jax_vectorcrush(rule, numrep):
    """The raw rows ``bulk_crush_rows`` leaves on the device (here the CPU)
    against the reference's JAX VectorCrush on the same pool's seeds."""
    ref_vec = load_reference_vectorized()
    ref = make_ref_map(5, [3, 4], pg_num=64)
    ref.osds.update({o: OsdInfo(up=True, weight=0x10000) for o in range(12)})
    ref.invalidate_placement_cache()
    weights = ref.osd_weights()
    pool = ref.pools[1]
    pps = pm_mod.pool_pps(pool)
    want = ref_vec.VectorCrush(ref.crush, rule).map_pgs(pps, numrep, weights)
    m = port_of(ref)
    rows, used = pm_mod.bulk_crush_rows(m.crush, rule,
                                        seed_tensor(pps, "cpu"), numrep,
                                        weights, fused="always")
    assert used and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool", [
    PoolSpec(pool_id=1, name="rbd", pg_num=4096, pgp_num=4096),
    PoolSpec(pool_id=7, name="split", pg_num=200, pgp_num=150),
    PoolSpec(pool_id=2, name="legacy", pg_num=64, pgp_num=64, flags=0)],
    ids=["rbd", "pgp_num below pg_num", "no hashpspool"])
def test_pool_seeds_match_reference_pool_pps(pool):
    """The seeds made on the device: the reference's pps (crush_hash32_2
    over the stable mod), wrapped to int32 (values >= 2^31 included)."""
    want = ref_pool_pps(pool)
    got = pm_mod.pool_seeds(pool, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if pool.flags & 1:
        assert (want >= 2**31).any()


def test_scalar_rows_go_to_the_seeds_device():
    ref = make_ref_map(2, [4, 4])
    m = port_of(ref)
    pps = pm_mod.pool_pps(m.pools[1])
    rows, used = pm_mod.bulk_crush_rows(m.crush, 0, seed_tensor(pps, "cpu"),
                                        3, m.osd_weights(), fused="never")
    assert not used and rows.dtype == torch.int32
    want, _ = pm_mod.bulk_crush(m.crush, 0, pps, 3, m.osd_weights(),
                                fused="always", device="cpu")
    np.testing.assert_array_equal(rows.numpy(), want)


# -- deltas and incrementals ------------------------------------------------

def _incremental(kind: str, ref: RefOSDMap, rnd: random.Random) -> dict:
    ups = sorted(o for o, i in ref.osds.items() if i.up)
    every = sorted(ref.osds)
    return {
        "down": {"new_down": rnd.sample(ups, 2)},
        "out": {"new_out": rnd.sample(every, 2)},
        "reweight": {"new_weights": {rnd.choice(every): 0x6000,
                                     rnd.choice(every): 0}},
        "up": {"new_up": {o: None for o in every if o not in ups}},
        "pg_temp": {"new_pg_temp": {
            "1.3": rnd.sample(every, 5), "2.4": [-1, every[0], -1, -1],
            next(iter(ref.pg_temp)): []}},
        "upmap": {"new_pg_upmap_items": {"2.6": [[every[0], every[1]]]},
                  "removed_pg_upmap_items": list(ref.pg_upmap_items)[:2]},
        "pools": {"new_pools": {
            3: {"pool_id": 3, "name": "fresh", "pg_num": 8, "pgp_num": 8,
                "size": 3},
            2: {"pool_id": 2, "name": "ec", "type": POOL_TYPE_ERASURE,
                "size": 4, "pg_num": 24, "pgp_num": 24, "crush_rule": 1}},
            "removed_pools": [11]},
        "crush": {"new_crush": ref_crush_to_dict(build_hierarchy([4, 3]))},
    }[kind]


KINDS = ["down", "out", "reweight", "up", "pg_temp", "upmap", "pools",
         "crush"]


@pytest.mark.parametrize("kind", KINDS)
def test_delta_after_each_incremental_kind(kind):
    rnd = random.Random(KINDS.index(kind))
    ref = make_ref_map(40 + KINDS.index(kind), [4, 4], extra_pool=True)
    m = port_of(ref)
    prev, ref_prev = m.placement_cache(), RefPGMapping.build(ref,
                                                             fused="never")
    fields = _incremental(kind, ref, rnd)
    ref.apply_incremental(RefIncremental(epoch=ref.epoch + 1, **fields))
    m.apply_incremental(Incremental(epoch=m.epoch + 1, **fields))
    assert m.peek_placement_cache() is None
    cur, ref_cur = m.placement_cache(), RefPGMapping.build(ref,
                                                           fused="never")
    assert_same_table(ref, ref_cur, cur, scalar=False)
    got = cur.delta(prev, perf=m.placement_perf)
    assert got == ref_cur.delta(ref_prev)
    assert m.placement_perf.get("delta_pgs") == len(got)
    # the brute-force diff of the two tables' lists
    old, new, brute = prev.tables(), cur.tables(), []
    for pid in sorted(set(old) | set(new)):
        n_old = old[pid][0].shape[0] if pid in old else 0
        n_new = new[pid][0].shape[0] if pid in new else 0
        brute += [(pid, pg) for pg in range(max(n_old, n_new))
                  if pg >= min(n_old, n_new)
                  or prev.lookup(pid, pg) != cur.lookup(pid, pg)]
    assert got == brute


def test_placement_neutral_incremental_carries_the_table():
    ref = make_ref_map(60, [3, 3, 4])
    m = port_of(ref)
    before = m.placement_cache()
    weights = m.osd_weights()
    m.apply_incremental(Incremental(
        epoch=m.epoch + 1, new_up_thru={0: 5}, new_hosts={1: "h"},
        new_blocklist={"client.1:0": 9e9}))
    assert m.peek_placement_cache() is before
    assert m.osd_weights() is weights
    assert m.placement_cache().delta(before) == []
    assert m.placement_perf.get("bulk_recomputes") == 1
    m.apply_incremental(Incremental(epoch=m.epoch + 1, new_weights={0: 1}))
    assert m.peek_placement_cache() is None          # peek never builds
    assert m.placement_perf.get("bulk_recomputes") == 1
    assert m.placement_cache() is not before
    assert m.placement_perf.get("bulk_recomputes") == 2


def test_epoch_invalidation_no_stale_reads():
    ref = make_ref_map(42, [4, 4])
    m = port_of(ref)
    up0, _ = m.pg_to_up_acting(1, 5)
    m.apply_incremental(Incremental(epoch=m.epoch + 1, new_down=up0[:1]))
    up1, act1 = m.pg_to_up_acting(1, 5)
    assert up0[0] not in up1
    assert (up1, act1) == m._pg_to_up_acting_scalar(1, 5)
    assert m.placement_cache().epoch == m.epoch
    pgid = m.pg_name(1, 5)
    m.apply_incremental(Incremental(
        epoch=m.epoch + 1, new_pg_temp={pgid: list(reversed(up1))}))
    assert m.pg_to_up_acting(1, 5) == (up1, list(reversed(up1)))


def test_osd_weights_memoized_per_generation():
    m = port_of(make_ref_map(7, [4, 4]))
    w0 = m.osd_weights()
    assert m.osd_weights() is w0
    m.apply_incremental(Incremental(epoch=m.epoch + 1,
                                    new_weights={0: 0x2000}))
    w1 = m.osd_weights()
    assert w1 is not w0 and w1[0] == 0x2000
    m.osds[1].weight = 0x3000
    m.invalidate_placement_cache()
    assert m.osd_weights()[1] == 0x3000


# -- serialization, counters, devices ---------------------------------------

def test_serialization_round_trip():
    ref = make_ref_map(13, [3, 3, 4], extra_pool=True)
    m = port_of(ref)
    assert m.to_dict() == ref.to_dict()
    m2 = OSDMap.from_dict(m.to_dict(), device="cpu")
    back = RefOSDMap.from_dict(m2.to_dict())
    assert back.to_dict() == ref.to_dict()
    a, b = m.placement_cache(), m2.placement_cache()
    for pid in a.tables():
        for x, y in zip(a.tables()[pid], b.tables()[pid]):
            np.testing.assert_array_equal(x, y)
    assert_same_table(ref, RefPGMapping.build(ref, fused="never"), b,
                      scalar=False)


def test_perf_counters():
    ref = make_ref_map(21, [4, 4], pg_num=8)
    m = port_of(ref)
    m.pg_to_up_acting(1, 0)
    m.pg_to_up_acting(2, 1)
    d = m.placement_perf.dump()
    assert d["bulk_recomputes"] == 1 and d["lookups"] == 2
    assert d["fused_pools"] + d["scalar_pools"] == 2
    assert d["recompute"]["avgcount"] == 1
    assert d["recompute_pgs_per_s"] > 0
    m.apply_incremental(Incremental(epoch=m.epoch + 1, new_down=[0]))
    m.pg_to_up_acting(1, 0)
    assert m.placement_perf.dump()["bulk_recomputes"] == 2


def test_iter_all_and_pg_count():
    ref = make_ref_map(23, [4, 4], extra_pool=True)
    ref_pm, _, pm = build_both(ref, "always")
    assert pm.pg_count() == ref_pm.pg_count() == 40
    assert list(pm.iter_all()) == list(ref_pm.iter_all())


def test_seeds_are_kept_per_pool_spec(monkeypatch):
    """A reweight or down epoch reuses each pool's seeds; a pg_num change
    makes them anew."""
    made = []
    real = pm_mod.pool_seeds
    monkeypatch.setattr(pm_mod, "_SEEDS", {})
    monkeypatch.setattr(pm_mod, "pool_seeds",
                        lambda pool, dev: made.append(pool.pool_id)
                        or real(pool, dev))
    ref = make_ref_map(24, [4, 4])
    m = port_of(ref)
    first, ref_first = m.placement_cache(), RefPGMapping.build(
        ref, fused="never")
    assert sorted(made) == [1, 2]
    for osdmap, inc in ((m, Incremental), (ref, RefIncremental)):
        osdmap.apply_incremental(inc(epoch=osdmap.epoch + 1, new_down=[0],
                                     new_weights={1: 0x4000}))
    m.placement_cache()
    assert sorted(made) == [1, 2]
    s1 = pm_mod.cached_pool_seeds(m.pools[1], torch.device("cpu"))
    assert s1 is pm_mod.cached_pool_seeds(m.pools[1], torch.device("cpu"))
    resize = {1: {"pool_id": 1, "name": "rep", "size": 3, "pg_num": 24,
                  "pgp_num": 24}}
    for osdmap, inc in ((m, Incremental), (ref, RefIncremental)):
        osdmap.apply_incremental(inc(epoch=osdmap.epoch + 1,
                                     new_pools=resize))
    cur, ref_cur = m.placement_cache(), RefPGMapping.build(ref,
                                                           fused="never")
    assert sorted(made) == [1, 1, 2]
    assert_same_table(ref, ref_cur, cur, scalar=False)
    assert cur.delta(first) == ref_cur.delta(ref_first)


MGR_POOL = PoolSpec(pool_id=1, name=".mgr", pg_num=1, pgp_num=1)


class _Launches:
    """Stand-ins for K5's and K6's mappers on a device that is not the CPU
    (the ``meta`` device stands in for the card here): the real mappers'
    refusals, built on the CPU; each launch counted (``n`` K5's, ``k6``
    K6's), its rows NONE."""

    def __init__(self, monkeypatch):
        self.n = self.k6 = 0
        real = pm_mod._vector_crush_for
        real_k6 = pm_mod._rule_lanes_for
        launches = self

        def mapper(crush_map, ruleno, dev):
            vc = real(crush_map, ruleno, "cpu")

            class Card:
                firstn = vc.firstn

                def map_device(self, xs, numrep, w):
                    launches.n += 1
                    return torch.full((xs.shape[0], numrep), 0,
                                      dtype=torch.int32, device=xs.device)
            return Card()

        def general(crush_map, ruleno, dev):
            real_k6(crush_map, ruleno, "cpu")

            class Card:
                def map_device(self, xs, numrep, w):
                    launches.k6 += 1
                    return torch.full((xs.shape[0], numrep), 0,
                                      dtype=torch.int32, device=xs.device)
            return Card()
        monkeypatch.setattr(pm_mod, "_vector_crush_for", mapper)
        monkeypatch.setattr(pm_mod, "_rule_lanes_for", general)

        def no_sweep(*args, **kwargs):
            raise AssertionError("a card's seeds were mapped on the host")
        monkeypatch.setattr(rule_lanes, "crush_do_rule", no_sweep)


@pytest.mark.parametrize("fused", ["auto", "always"])
def test_card_maps_a_one_pg_pool_with_the_kernel(monkeypatch, fused):
    """Seeds on the card take K5 whatever their count: Ceph's .mgr pool
    (one PG) on a cold map, below FUSED_MIN_LANES, is not swept on the
    host."""
    launches = _Launches(monkeypatch)
    m = port_of(make_ref_map(27, [4, 4]))
    seeds = pm_mod.pool_seeds(MGR_POOL, "meta")
    assert seeds.shape == (1,) and 1 < pm_mod.FUSED_MIN_LANES
    rows, used = pm_mod.bulk_crush_rows(m.crush, 0, seeds, 3,
                                        m.osd_weights(), fused=fused)
    assert used and launches.n == 1
    assert rows.shape == (1, 3) and rows.device.type == "meta"


@pytest.mark.parametrize("fused", ["auto", "always"])
@pytest.mark.parametrize("case", ["depth 1", "no such rule"])
def test_card_maps_nothing_without_a_launch(monkeypatch, case, fused):
    """A rule that maps nothing gives NONE rows made on the card, with no
    launch and no host sweep."""
    launches = _Launches(monkeypatch)
    m = port_of(make_ref_map(28, DEPTHS[1] if case == "depth 1" else [4, 4]))
    rule = 0 if case == "depth 1" else 9
    rows, used = pm_mod.bulk_crush_rows(
        m.crush, rule, pm_mod.pool_seeds(MGR_POOL, "meta"), 3,
        m.osd_weights(), fused=fused)
    assert not used and launches.n == 0
    assert rows.shape == (1, 3) and rows.device.type == "meta"


def test_card_refuses_the_host_sweep(monkeypatch):
    """On the card ``fused="never"`` raises ValueError, and a shape K5 does
    not express (pre-jewel ``chooseleaf_stable`` 0) takes one K6 launch and
    no K5 launch: nothing falls back to the host."""
    launches = _Launches(monkeypatch)
    m = port_of(make_ref_map(29, [4, 4]))
    seeds = pm_mod.pool_seeds(MGR_POOL, "meta")
    with pytest.raises(ValueError, match="host"):
        pm_mod.bulk_crush_rows(m.crush, 0, seeds, 3, m.osd_weights(),
                               fused="never")
    m.crush.tunables.chooseleaf_stable = 0
    with pytest.raises(Unexpressed, match="jewel"):
        VectorCrush(m.crush, 0, device="cpu")
    rows, used = pm_mod.bulk_crush_rows(m.crush, 0, seeds, 3, m.osd_weights())
    assert used and (launches.n, launches.k6) == (0, 1)
    assert rows.shape == (1, 3) and rows.device.type == "meta"


def _card_route(monkeypatch) -> list:
    """Route every pool of a CPU build through the card's route
    (``card_rows``, here on CPU seeds: the bulk mapper's plain version
    stands for K5); the rules it was asked for."""
    routed = []

    def card_route(crush_map, ruleno, seeds, numrep, weights, **kwargs):
        routed.append(ruleno)
        return pm_mod.card_rows(crush_map, ruleno, seeds, numrep, weights)
    monkeypatch.setattr(pm_mod, "bulk_crush_rows", card_route)
    return routed


def _straw_or_vary_r_map(kind: str) -> RefOSDMap:
    """A reference map in straw (not straw2) buckets, or with jewel's
    tunables but chooseleaf_vary_r = 0: shapes the reference's bulk mapper
    refuses and K5 expresses."""
    ref = make_ref_map(31, [3, 4])
    if kind == "straw":
        ref.crush = build_hierarchy([3, 4], alg=CRUSH_BUCKET_STRAW)
    else:
        ref.crush.tunables.chooseleaf_vary_r = 0
    return ref


@pytest.mark.parametrize("kind", ["straw", "vary_r 0"])
def test_card_maps_straw_and_vary_r_0_with_k5(monkeypatch, kind):
    """The card's route maps a straw map and a vary_r 0 map with the bulk
    mapper, nothing on the host: the table equals the reference's
    ``fused="never"`` build (its scalar pipeline) entry for entry, and every
    pool counts in ``fused_pools``."""
    ref = _straw_or_vary_r_map(kind)
    with pytest.raises(ValueError):
        load_reference_vectorized().VectorCrush(ref.crush, 0)
    m = port_of(ref)
    routed = _card_route(monkeypatch)
    monkeypatch.setattr(pm_mod, "_sweep", None)
    pm = PGMapping.build(m)
    assert sorted(routed) == [0, 1]
    assert pm.fused_pools == len(ref.pools) and pm.scalar_pools == 0
    assert_same_table(ref, RefPGMapping.build(ref, fused="never"), pm)


def test_card_raises_for_a_shape_k5_does_not_express(monkeypatch):
    """A map shape K5 does not express (a host bucket holding an osd and a
    bucket) takes K6 on the card's route, once a pool, and neither K5 nor
    the host sweep: the table (K6's plain version here, on CPU seeds) equals
    the reference's ``fused="never"`` build entry for entry, and every pool
    counts as mapped by a kernel."""
    ref = make_ref_map(33, [3, 4])
    host = ref.crush.buckets[ref.crush.buckets[-1].items[0]]
    host.items.append(ref.crush.buckets[-1].items[1])
    host.item_weights.append(0x10000)
    m = port_of(ref)
    with pytest.raises(Unexpressed, match="mixed osd/bucket"):
        VectorCrush(m.crush, 0, device="cpu")
    routed = _card_route(monkeypatch)
    monkeypatch.setattr(pm_mod, "_sweep", None)
    k6 = []
    real = pm_mod._rule_lanes_for
    monkeypatch.setattr(pm_mod, "_rule_lanes_for",
                        lambda *a: k6.append(a[1]) or real(*a))
    monkeypatch.setattr(VectorCrush, "map_device", None)
    pm = PGMapping.build(m)
    assert sorted(routed) == sorted(k6) == [0, 1]
    assert pm.fused_pools == len(ref.pools) and pm.scalar_pools == 0
    assert_same_table(ref, RefPGMapping.build(ref, fused="never"), pm)


def test_card_route_still_raises_a_kernel_failure():
    """A shape K5 takes goes to K5 alone: its failure is not answered by
    the sweep."""
    m = port_of(make_ref_map(32, [4, 4]))

    class Failing:
        def map_device(self, seeds, numrep, weights):
            raise RuntimeError("crush_map_rule: kernel launch failed")
    seeds = pm_mod.pool_seeds(MGR_POOL, "cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pm_mod.card_rows(m.crush, 0, seeds, 3, m.osd_weights(),
                         mapper=lambda *args: Failing())


@pytest.mark.parametrize("rule", [0, 1, 9], ids=["firstn", "indep", "none"])
def test_rules_that_map_nothing_give_none_rows(rule):
    """A depth-1 map's chooseleaf rules and a rule the map lacks: the bulk
    route's rows equal the scalar sweep's (all CRUSH_ITEM_NONE), and no
    mapper is built."""
    m = port_of(make_ref_map(30, DEPTHS[1]))
    if rule == 9:
        m = port_of(make_ref_map(30, [4, 4]))
    pps = pm_mod.pool_pps(m.pools[1])
    want = pm_mod.bulk_crush(m.crush, rule, pps, 4, m.osd_weights(),
                             fused="never", device="cpu")[0]
    rows, used = pm_mod.bulk_crush(m.crush, rule, pps, 4, m.osd_weights(),
                                   fused="always", device="cpu")
    assert not used and (want == CRUSH_ITEM_NONE).all()
    np.testing.assert_array_equal(rows, want)
    assert not m.crush.__dict__.get("_vc_cache")


def test_cuda_is_the_default_and_only_the_build_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = make_ref_map(25, [4, 4])
    m = OSDMap.from_dict(ref.to_dict())
    assert m.device is None
    m.apply_incremental(Incremental(epoch=m.epoch + 1, new_down=[0]))
    m.to_dict()
    assert m.peek_placement_cache() is None
    with pytest.raises(RuntimeError, match="CUDA"):
        m.placement_cache()
    with pytest.raises(RuntimeError, match="CUDA"):
        m.pg_to_up_acting(1, 0)
    assert OSDMap(device="cpu").placement_cache().pg_count() == 0


@pytest.mark.parametrize("fused", ["auto", "always"])
def test_kernel_failure_fails_the_build(monkeypatch, fused):
    """No second route: a K5 failure is not answered by the scalar sweep."""
    def fail(self, xs, numrep, osd_weights):
        raise RuntimeError("crush_map_rule: kernel launch failed with CUDA "
                           "error 98")
    monkeypatch.setattr(VectorCrush, "map_device", fail)
    m = port_of(make_ref_map(26, [4, 4]))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        PGMapping.build(m, fused=fused, min_lanes=1)
