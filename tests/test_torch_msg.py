"""The port's messenger against ceph_tpu's: the same frames on the wire.

``ceph_tpu_torch/msg/`` is a copy of ``ceph_tpu/msg/`` with the frame CRC
taken from the port's host engine (``ceph_tpu_torch/native.py``).  Made
from the same seeded inputs, every frame, typed payload, compressed frame
and sealed ticket must be byte-equal between the two packages and decode
in the other; and a messenger of one package must talk to one of the
other over loopback.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu.common import cephx as ref_cephx
from ceph_tpu.compressor import Compressor as RefCompressor
from ceph_tpu.msg import Message as RefMessage, Messenger as RefMessenger
from ceph_tpu.msg import message as ref_message, wire_types as ref_wire
from ceph_tpu_torch.common import cephx
from ceph_tpu_torch.compressor import Compressor
from ceph_tpu_torch.msg import Message, Messenger
from ceph_tpu_torch.msg import message, wire_types


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _payload(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _data(kind: str, seed: int) -> tuple[dict, list[bytes]]:
    """A message payload of ``kind`` and its segments, from ``seed``."""
    rng = np.random.default_rng(seed)
    tid = int(rng.integers(1, 1 << 40))
    segs = [_payload(rng, int(rng.integers(0, 9000)))
            for _ in range(int(rng.integers(0, 4)))]
    pgid = f"{int(rng.integers(1, 9))}.{int(rng.integers(0, 64)):x}"
    entry = {"op": "modify", "oid": f"obj-{seed}",
             "v": [int(rng.integers(1, 99)), int(rng.integers(1, 1 << 33))],
             "pv": [0, 0], "m": [{"op": "write", "off": 0,
                                  "len": len(segs[0]) if segs else 0}],
             "rq": [f"client.{seed}", tid]}
    if kind == "osd_op":
        d = {"pgid": pgid, "oid": f"obj-{seed}", "tid": tid,
             "reqid": [f"client.{seed}:1", tid],
             "ops": [{"op": "writefull", "seg": 0},
                     {"op": "setxattr", "name": "a", "value": "ff"}]}
    elif kind == "osd_op_reply":
        d = {"tid": tid, "epoch": int(rng.integers(1, 500)),
             "results": [{"ok": True, "seg": 0}, {"ok": True}],
             "version": [3, tid]}
        if seed % 2:
            d["err"] = "ENOENT"
    elif kind in ("rep_op", "rep_op_reply"):
        d = {"pgid": pgid, "tid": tid}
        if kind == "rep_op":
            d.update(entry=entry, muts=[{"op": "write", "off": 0}],
                     log_only=bool(seed % 2))
        else:
            d.update(ok=True, shard=int(rng.integers(0, 11)))
    elif kind in ("osd_ping", "osd_ping_reply"):
        d = {"from": int(rng.integers(0, 100)),
             "stamp": float(rng.random() * 1e6),
             "epoch": int(rng.integers(1, 500))}
    elif kind == "mon_command":
        d = {"cmd": "osd pool create",
             "args": {"name": f"pool{seed}", "type": "erasure",
                      "pg_num": int(rng.integers(1, 64)),
                      "erasure_code_profile": "p"}, "tid": tid}
    elif kind == "ec_subop_write":
        d = {"pgid": pgid, "oid": f"obj-{seed}", "shard": seed % 11,
             "entry": entry, "crc": int(rng.integers(0, 1 << 32)),
             "size": int(rng.integers(0, 1 << 22)), "tid": tid}
    elif kind == "pg_notify":
        d = {"pgid": pgid, "info": {
            "pgid": pgid, "last_update": [4, tid], "last_complete": [4, 1],
            "log_tail": [0, 0], "last_epoch_started": 3,
            "same_interval_since": 2, "backfill_complete": True,
            "last_backfill": ""}, "entries": [entry], "none": None,
            "ratio": 0.25}
    else:
        raise KeyError(kind)
    return d, segs


KINDS = ("osd_op", "osd_op_reply", "rep_op", "rep_op_reply", "osd_ping",
         "osd_ping_reply", "mon_command", "ec_subop_write", "pg_notify")


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_frames_are_byte_equal_and_decode_across(kind, seed):
    d, segs = _data(kind, seed)
    ref = RefMessage(kind, d, list(segs), seq=seed * 7, from_name="osd.3")
    port = Message(kind, d, list(segs), seq=seed * 7, from_name="osd.3")
    buf = port.encode()
    assert buf == ref.encode()
    for dec in (Message.decode(ref.encode()), RefMessage.decode(buf)):
        assert dec.type == kind and dec.data == d
        assert [bytes(s) for s in dec.segments] == segs
        assert dec.seq == seed * 7 and dec.from_name == "osd.3"


@pytest.mark.parametrize("name", sorted(ref_wire.WIRE_CODECS))
def test_typed_codecs_match(name):
    assert set(wire_types.WIRE_CODECS) == set(ref_wire.WIRE_CODECS)
    from ceph_tpu.common.denc import Decoder as RefDecoder, \
        Encoder as RefEncoder
    from ceph_tpu_torch.common.denc import Decoder, Encoder
    for seed in range(3):
        d, _ = _data(name, seed)
        e_ref, e_port = RefEncoder(), Encoder()
        ref_wire.WIRE_CODECS[name][0](e_ref, d)
        wire_types.WIRE_CODECS[name][0](e_port, d)
        assert e_port.bytes() == e_ref.bytes()
        assert wire_types.WIRE_CODECS[name][1](
            Decoder(e_ref.bytes())) == d
        assert ref_wire.WIRE_CODECS[name][1](
            RefDecoder(e_port.bytes())) == d


@pytest.mark.parametrize("algo", ["zlib", "lzma", "bz2"])
def test_compressed_frames_match(algo):
    d, _ = _data("ec_subop_write", 5)
    rng = np.random.default_rng(11)
    # compressible segments: a repeated random block
    segs = [_payload(rng, 512) * 16, bytes(3000)]
    ref_c, port_c = RefCompressor.create(algo), Compressor.create(algo)
    raw_ref = RefMessage("ec_subop_write", d, list(segs)).encode()
    raw = Message("ec_subop_write", d, list(segs)).encode()
    assert raw == raw_ref
    wrapped = message.wrap_frame(raw, compressor=port_c)
    assert wrapped[:4] == message.COMP_MAGIC
    assert wrapped == ref_message.wrap_frame(raw_ref, compressor=ref_c)
    assert message.unwrap_frame(
        ref_message.wrap_frame(raw_ref, compressor=ref_c),
        compressor=port_c) == raw
    assert ref_message.unwrap_frame(wrapped, compressor=ref_c) == raw


def test_sealed_tickets_open_across():
    key = bytes(np.random.default_rng(3).integers(0, 256, 32,
                                                  dtype=np.uint8))
    obj = {"entity": "client.admin", "gen": 7, "expires": 1.5e9,
           "caps": {"osd": "allow rwx"}}
    assert cephx.unseal(key, ref_cephx.seal(key, obj)) == obj
    assert ref_cephx.unseal(key, cephx.seal(key, obj)) == obj
    with pytest.raises(Exception):
        cephx.unseal(bytes(32), ref_cephx.seal(key, obj))


def test_corrupt_frames_are_refused_by_both():
    d, segs = _data("osd_op", 9)
    buf = bytearray(Message("osd_op", d, segs or [b"x"]).encode())
    buf[12] ^= 0x40
    for cls in (Message, RefMessage):
        with pytest.raises(ValueError, match="crc"):
            cls.decode(bytes(buf))


@pytest.mark.parametrize("sender", ["ceph_tpu", "ceph_tpu_torch"])
def test_messengers_talk_across_packages(sender):
    """A messenger of each package sends typed and generic messages with
    segments (big enough for the executor-thread CRC) to one of the other
    package over loopback; every message arrives intact and in order."""
    async def main():
        ref = RefMessenger("osd.1")
        port = Messenger("osd.2")
        a, b = (ref, port) if sender == "ceph_tpu" else (port, ref)
        msg_cls = RefMessage if a is ref else Message
        got: list = []
        done = asyncio.Event()
        sent = []

        async def on_msg(conn, msg):
            got.append(msg)
            if len(got) == len(sent):
                done.set()

        b.add_dispatcher(on_msg)
        await a.bind()
        addr = await b.bind()
        try:
            for i, kind in enumerate(KINDS):
                d, segs = _data(kind, 20 + i)
                if i == 0:
                    segs = [bytes(2 << 20)]      # past OFFLOAD_THRESHOLD
                sent.append((kind, d, segs))
            for kind, d, segs in sent:
                await asyncio.wait_for(
                    a.send(addr, b.name, msg_cls(kind, d, list(segs))), 10)
            await asyncio.wait_for(done.wait(), 20)
            assert [(m.type, m.data, [bytes(s) for s in m.segments])
                    for m in got] == sent
        finally:
            await a.shutdown()
            await b.shutdown()
    run(main())
