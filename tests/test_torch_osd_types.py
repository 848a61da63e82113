"""The port's OSD types and PG log against ceph_tpu's.

``ceph_tpu_torch/osd/types.py`` and ``pg_log.py`` are copies: on the same
seeded histories their on-disk encodings (denc) must be byte-equal and
decode in the other package, and the log machinery peering runs (merge,
divergent rewind, a replica's missing set, trim) must give the same
answers.
"""

import numpy as np
import pytest

from ceph_tpu.common.denc import Decoder as RefDecoder, Encoder as RefEncoder
from ceph_tpu.osd import pg_log as ref_pg_log, types as ref_types
from ceph_tpu_torch.common.denc import Decoder, Encoder
from ceph_tpu_torch.osd import pg_log, types

SEEDS = [0, 1, 2, 3]


def _history(seed: int):
    """A seeded history: a common prefix, then an authoritative and a
    divergent branch, as plain tuples both packages build from."""
    rng = np.random.default_rng(seed)
    oids = [f"obj{i}" for i in range(int(rng.integers(3, 8)))]
    epoch, v = 1, 0
    prefix, auth, div = [], [], []
    last: dict[str, tuple] = {}

    def entry(branch_last):
        nonlocal v
        v += int(rng.integers(1, 3))
        oid = oids[int(rng.integers(len(oids)))]
        op = "delete" if rng.random() < 0.15 else "modify"
        prior = branch_last.get(oid, (0, 0))
        muts = [] if op == "delete" else [
            {"op": "write", "off": int(rng.integers(0, 4096)),
             "len": int(rng.integers(1, 4096))}]
        rq = (f"client.{int(rng.integers(9))}", int(rng.integers(1 << 40))) \
            if rng.random() < 0.8 else None
        e = (op, oid, (epoch, v), prior, muts, rq)
        branch_last[oid] = (epoch, v)
        return e

    for _ in range(int(rng.integers(4, 12))):
        prefix.append(entry(last))
    base = dict(last)
    auth_last, div_last = dict(base), dict(base)
    v0 = v
    for _ in range(int(rng.integers(0, 6))):
        div.append(entry(div_last))
    v = v0
    epoch += 1
    for _ in range(int(rng.integers(1, 8))):
        auth.append(entry(auth_last))
    return prefix, auth, div


def _build(T, L, tuples):
    return [T.LogEntry(op=op, oid=oid, version=T.EVersion(*ver),
                       prior_version=T.EVersion(*prior), mutations=muts,
                       reqid=rq)
            for op, oid, ver, prior, muts, rq in tuples]


def _log(T, L, entries, tail=(0, 0)):
    log = L.PGLog(tail=T.EVersion(*tail))
    for e in entries:
        log.add(e)
    return log


def _enc(obj, enc_cls):
    enc = enc_cls()
    obj.denc(enc)
    return enc.bytes()


def _info(T, seed):
    rng = np.random.default_rng(100 + seed)
    return T.PGInfo(
        pgid=f"{seed}.{int(rng.integers(0, 256)):x}",
        last_update=T.EVersion(int(rng.integers(1, 50)),
                               int(rng.integers(1, 1 << 40))),
        last_complete=T.EVersion(int(rng.integers(1, 50)),
                                 int(rng.integers(1, 1 << 20))),
        log_tail=T.EVersion(1, int(rng.integers(0, 100))),
        last_epoch_started=int(rng.integers(0, 1 << 31)),
        same_interval_since=int(rng.integers(0, 1 << 31)),
        backfill_complete=bool(seed % 2),
        last_backfill=f"obj{seed}" if seed % 2 == 0 else "")


@pytest.mark.parametrize("seed", SEEDS)
def test_log_entries_and_logs_encode_alike(seed):
    prefix, auth, div = _history(seed)
    for tuples in (prefix, prefix + auth, prefix + div):
        ref = _log(ref_types, ref_pg_log, _build(ref_types, ref_pg_log,
                                                 tuples))
        port = _log(types, pg_log, _build(types, pg_log, tuples))
        for r, p in zip(ref.entries, port.entries):
            buf = _enc(p, Encoder)
            assert buf == _enc(r, RefEncoder)
            assert types.LogEntry.dedenc(Decoder(_enc(r, RefEncoder))) == p
            assert ref_types.LogEntry.dedenc(RefDecoder(buf)) == r
            assert p.to_dict() == r.to_dict()
        buf = _enc(port, Encoder)
        assert buf == _enc(ref, RefEncoder)
        back = ref_pg_log.PGLog.dedenc(RefDecoder(buf))
        assert back.to_dict() == ref.to_dict()
        assert pg_log.PGLog.dedenc(
            Decoder(_enc(ref, RefEncoder))).to_dict() == port.to_dict()
        assert pg_log.PGLog.from_dict(ref.to_dict()).to_dict() == \
            port.to_dict()


@pytest.mark.parametrize("seed", SEEDS)
def test_info_missing_intervals_encode_alike(seed):
    ri, pi = _info(ref_types, seed), _info(types, seed)
    assert _enc(pi, Encoder) == _enc(ri, RefEncoder)
    assert types.PGInfo.dedenc(Decoder(_enc(ri, RefEncoder))) == pi
    assert ref_types.PGInfo.dedenc(RefDecoder(_enc(pi, Encoder))) == ri
    assert types.PGInfo.from_dict(ri.to_dict()) == pi

    rng = np.random.default_rng(200 + seed)
    rm, pm = ref_types.MissingSet(), types.MissingSet()
    for i in range(int(rng.integers(0, 10))):
        need = (int(rng.integers(1, 9)), int(rng.integers(1, 1 << 33)))
        have = (0, int(rng.integers(0, 5)))
        for T, ms in ((ref_types, rm), (types, pm)):
            ms.add(f"o{i % 4}", T.EVersion(*need), T.EVersion(*have))
    assert _enc(pm, Encoder) == _enc(rm, RefEncoder)
    assert types.MissingSet.dedenc(
        Decoder(_enc(rm, RefEncoder))).to_dict() == pm.to_dict()
    assert ref_types.MissingSet.dedenc(
        RefDecoder(_enc(pm, Encoder))).to_dict() == rm.to_dict()

    rp, pp = ref_types.PastIntervals(), types.PastIntervals()
    first = 1
    for _ in range(int(rng.integers(0, 6))):
        last = first + int(rng.integers(0, 20))
        acting = [int(x) for x in rng.integers(-1, 12, int(rng.integers(1, 6)))]
        rw = bool(rng.random() < 0.7)
        rp.note_interval(first, last, acting, rw)
        pp.note_interval(first, last, acting, rw)
        first = last + 1
    assert _enc(pp, Encoder) == _enc(rp, RefEncoder)
    assert types.PastIntervals.dedenc(
        Decoder(_enc(rp, RefEncoder))).to_dict() == rp.to_dict()
    assert pp.probe_targets([0, 1]) == rp.probe_targets([0, 1])


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_and_replica_missing_agree(seed):
    """Peering's log machinery on a divergent replica: merging the
    authoritative log, and the primary's view of what the replica
    lacks, give the same log, missing set and divergent entries."""
    prefix, auth, div = _history(seed)
    out = []
    for T, L in ((ref_types, ref_pg_log), (types, pg_log)):
        auth_log = _log(T, L, _build(T, L, prefix + auth))
        local = _log(T, L, _build(T, L, prefix + div))
        info = T.PGInfo(pgid="1.0", last_update=auth_log.head,
                        log_tail=auth_log.tail)
        replica_info = T.PGInfo(pgid="1.0", last_update=local.head)
        replica_missing = L.PGLog.proc_replica_log(
            replica_info, list(local.entries), auth_log)
        missing = T.MissingSet()
        divergent = local.merge(list(auth_log.entries), info, missing)
        trimmed = _log(T, L, _build(T, L, prefix + auth))
        mid = trimmed.entries[len(trimmed.entries) // 2].version
        trimmed.trim(mid)
        out.append((local.to_dict(), missing.to_dict(),
                    [e.to_dict() for e in divergent],
                    replica_missing.to_dict(), trimmed.to_dict(),
                    local.overlaps(info),
                    sorted(local.objects())))
    assert out[0] == out[1]


def test_non_overlapping_merge_replaces_the_log_alike():
    """A replica whose head predates the authoritative tail takes the
    authoritative log wholesale (the backfill case) in both packages."""
    prefix, auth, _ = _history(7)
    out = []
    for T, L in ((ref_types, ref_pg_log), (types, pg_log)):
        auth_log = _log(T, L, _build(T, L, prefix + auth))
        auth_log.trim(auth_log.entries[-2].version)
        stale = _log(T, L, _build(T, L, prefix[:2]))
        info = T.PGInfo(pgid="1.0", last_update=auth_log.head,
                        log_tail=auth_log.tail)
        missing = T.MissingSet()
        assert not stale.overlaps(info)
        stale.merge(list(auth_log.entries), info, missing)
        out.append((stale.to_dict(), missing.to_dict()))
    assert out[0] == out[1]
