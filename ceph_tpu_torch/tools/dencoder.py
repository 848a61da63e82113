"""ceph-dencoder analog: inspect/verify versioned encodings.

    python -m ceph_tpu_torch.tools.dencoder list_types
    python -m ceph_tpu_torch.tools.dencoder type PGInfo decode < blob.bin
    python -m ceph_tpu_torch.tools.dencoder type PGInfo encode_sample > blob.bin
    python -m ceph_tpu_torch.tools.dencoder corpus_check tests/fixtures/corpus
    python -m ceph_tpu_torch.tools.dencoder corpus_generate OUT_DIR

Reference: src/tools/ceph-dencoder (type registry, decode/dump-json,
count_tests/select_test sample generators) + ceph-object-corpus
(committed encodings every build must keep decoding AND re-encode
byte-identically).

Port of ``ceph_tpu/tools/dencoder.py``: the same types, samples, output
and corpus contract, over the port's ``common/denc``, ``osd/types``,
``osd/pg_log`` and ``msg``.  ``corpus_generate`` writes only under the
root its caller names.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..common.denc import Decoder, denc_bytes
from ..osd.pg_log import PGLog
from ..osd.types import (
    EVersion, LogEntry, MissingSet, PastIntervals, PGInfo, ZERO,
)


def _samples_pginfo():
    yield PGInfo(pgid="1.2a", last_update=EVersion(9, 140),
                 last_complete=EVersion(9, 133),
                 log_tail=EVersion(3, 12), last_epoch_started=9,
                 same_interval_since=7, backfill_complete=False,
                 last_backfill="obj_0042")
    yield PGInfo()


def _samples_logentry():
    yield LogEntry(op="modify", oid="rbd_data.abc.0000",
                   version=EVersion(4, 77), prior_version=EVersion(4, 70),
                   mutations=[{"op": "write", "off": 0, "len": 42}],
                   reqid=("client.a:1", 9))
    yield LogEntry(op="delete", oid="gone", version=EVersion(5, 1),
                   prior_version=ZERO, mutations=[], reqid=None)


def _samples_missing():
    ms = MissingSet()
    ms.add("a", need=EVersion(2, 5), have=ZERO)
    ms.add("b", need=EVersion(3, 9), have=EVersion(1, 1))
    yield ms
    yield MissingSet()


def _samples_pastintervals():
    pi = PastIntervals()
    pi.note_interval(3, 7, [2, 0, 1])
    pi.note_interval(8, 11, [2, -1, 1])
    pi.note_interval(12, 12, [0, 3, 1], rw=False)
    yield pi
    yield PastIntervals()


def _samples_pglog():
    log = PGLog()
    for e in _samples_logentry():
        log.entries.append(e)
        log.head = e.version
    yield log


def _entry(cls, samples):
    """All registered types share denc/to_dict conventions; only the
    class and its sample generator differ."""
    return {
        "samples": samples,
        "enc": denc_bytes,
        "dec": lambda b, c=cls: c.dedenc(Decoder(b)),
        "dump": lambda o: o.to_dict(),
    }


def _samples_wire():
    """Wire frames: the denc meta envelope + typed hot-path codecs
    (msg/wire_types.py) must stay byte-stable -- a drift here breaks
    rolling upgrades mid-flight, not just on-disk state."""
    from ..msg import Message
    m = Message("osd_op", {"pgid": "1.2a", "oid": "obj-7", "tid": 42,
                           "reqid": ["client.a:ffee", 7],
                           "ops": [{"op": "write", "offset": 0,
                                    "length": 3,
                                    "data": {"seg": 0, "len": 3}}]},
                segments=[b"abc"])
    m.seq, m.from_name = 9, "client.a"
    yield m
    yield Message("osd_op_reply", {"tid": 42, "epoch": 11,
                                   "results": [{"ok": True}]})
    yield Message("osd_op_reply", {"tid": 43, "err": "ENOENT"})
    yield Message("rep_op", {"pgid": "1.2a", "tid": 5,
                             "entry": {"oid": "obj-7",
                                       "version": [9, 140]},
                             "muts": [{"op": "write", "offset": 0}]})
    yield Message("rep_op_reply", {"tid": 5, "from_osd": 3})
    yield Message("osd_ping", {"from_osd": 2, "stamp": 1234.5})
    # a generic (non-typed) message exercises the tagged-value path
    yield Message("paxos_begin", {"version": 7, "value": "v" * 20,
                                  "e": 2, "nested": {"a": [1, None],
                                                     "b": -1.5}})


def _wire_entry():
    from ..msg import Message
    return {
        "samples": _samples_wire,
        "enc": lambda m: m.encode(),
        "dec": Message.decode,
        "dump": lambda m: {"t": m.type, "seq": m.seq,
                           "from": m.from_name, "data": m.data,
                           "segs": [s.hex() for s in m.segments]},
        # frames start with 4-byte magic + u32 meta_len; the envelope
        # struct_v lives at offset 8 (default heuristic reads byte 0)
        "ver": lambda b: b[8:9],
    }


TYPES = {
    "PGInfo": _entry(PGInfo, _samples_pginfo),
    "LogEntry": _entry(LogEntry, _samples_logentry),
    "MissingSet": _entry(MissingSet, _samples_missing),
    "PastIntervals": _entry(PastIntervals, _samples_pastintervals),
    "PGLog": _entry(PGLog, _samples_pglog),
    "WireMessage": _wire_entry(),
}


def corpus_check(root: str) -> int:
    """Every committed blob must decode and re-encode byte-identically
    (the non-regression contract of ceph-object-corpus)."""
    failures = 0
    n = 0
    for tdir in sorted(Path(root).iterdir()):
        if not tdir.is_dir() or tdir.name not in TYPES:
            continue
        t = TYPES[tdir.name]
        for blob_path in sorted(tdir.glob("*.bin")):
            n += 1
            blob = blob_path.read_bytes()
            try:
                obj = t["dec"](blob)
                re = t["enc"](obj)
                if re != blob:
                    # the envelope's version byte (offset per type --
                    # wire frames carry a magic first): an OLD-version
                    # blob is decode-compat only (the reference keeps
                    # per-version corpus archives the same way); a
                    # SAME-version mismatch is a breaking format
                    # drift and fails
                    ver = t.get("ver", lambda b: b[:1])
                    if ver(blob) == ver(re):
                        print(f"FAIL {tdir.name}/{blob_path.name}: "
                              f"re-encode differs at same version "
                              f"({len(re)} vs {len(blob)} bytes)")
                        failures += 1
                        continue
                    if t["dump"](t["dec"](re)) != t["dump"](obj):
                        print(f"FAIL {tdir.name}/{blob_path.name}: "
                              f"upgraded re-encode loses semantics")
                        failures += 1
                        continue
                side = blob_path.with_suffix(".json")
                if side.exists():
                    want = json.loads(side.read_text())
                    if t["dump"](obj) != want:
                        print(f"FAIL {tdir.name}/{blob_path.name}: "
                              f"semantic dump differs")
                        failures += 1
            except Exception as e:
                print(f"FAIL {tdir.name}/{blob_path.name}: "
                      f"{type(e).__name__}: {e}")
                failures += 1
    print(f"checked {n} corpus encodings, {failures} failures")
    return 1 if failures else 0


def generate_corpus(root: str) -> int:
    for name, t in TYPES.items():
        d = Path(root) / name
        d.mkdir(parents=True, exist_ok=True)
        for i, obj in enumerate(t["samples"]()):
            (d / f"{i}.bin").write_bytes(t["enc"](obj))
            (d / f"{i}.json").write_text(
                json.dumps(t["dump"](obj), indent=1, sort_keys=True))
    print(f"corpus written under {root}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "list_types":
        for name in sorted(TYPES):
            print(name)
        return 0
    if cmd == "corpus_check":
        return corpus_check(argv[1])
    if cmd == "corpus_generate":
        return generate_corpus(argv[1])
    if cmd == "type" and len(argv) >= 3:
        t = TYPES.get(argv[1])
        if t is None:
            print(f"unknown type {argv[1]}", file=sys.stderr)
            return 2
        if argv[2] == "decode":
            obj = t["dec"](sys.stdin.buffer.read())
            print(json.dumps(t["dump"](obj), indent=1))
            return 0
        if argv[2] == "encode_sample":
            sys.stdout.buffer.write(t["enc"](next(t["samples"]())))
            return 0
        if argv[2] == "count_tests":
            print(sum(1 for _ in t["samples"]()))
            return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
