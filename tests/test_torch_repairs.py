"""Eleven faults the port repairs where ``ceph_tpu`` keeps them (deliberate
differences from the reference):

1. the OSD's blocklist fence names the client instance by its connection
   (peer name and messenger incarnation from the handshake), not by the
   op's ``reqid``: a fenced client that stamps another reqid is still
   refused, and an op whose reqid names another instance is refused;
2. a blocklist entry fences for as long as it is in the OSD's map,
   whatever the OSD's clock says of its expiry: the monitor's tick removes
   expired entries by an incremental;
3. the hello's flags byte is bound into the negotiation MAC: with a
   shared secret, a client that reads a flags byte with
   ``HELLO_ACCEPTS_TICKETS`` stripped fails the MAC.

And two the traffic harness found at 64 OSDs under a kill:

4. a peer that closes the stream mid-handshake (a daemon shutting down
   accepts, then closes) is a ``ConnectionError``, as a refused
   connection is, so PG peering backs off and retries instead of its
   task dying on an ``IncompleteReadError``;
5. a client op cancelled while it owns the Objecter's shared map fetch
   (its op timed out) no longer cancels the fetch the other ops wait on;
6. an op cancelled while ``PG._yield_to_commits`` takes the PG lock back
   leaves with the lock held, so its ``async with`` releases its own hold:
   the lock is neither released under another holder nor left taken;
7. a heartbeat peer that enters an OSD's set starts a fresh clock: the
   stamp it left the set with no longer reports it at once (at 64 OSDs a
   kill swaps ring neighbours, which reported live OSDs, whose epochs
   swapped more: the cascade of false mark-downs).

And one the client applications' drive found:

8. an RBD image's object map serializes its updates: writes in flight
   together (the image's 16-deep I/O) no longer lose an object's EXISTS
   mark to two racing first loads or two interleaved map saves.

And one CephFS's drive found on the card:

9. the MDS re-journals its write-cap custody (after every journal trim,
   and at activation) from a copy: a cap granted or released while an
   append awaits no longer kills the mutation that trimmed (its reply
   lost, the client resending) with "Set changed size during iteration".

And one the traffic harness's slow hosts showed:

10. a client op that waits long on a busy PG is not resent on a timer: the
    Objecter keeps one tid and one waiter for the op's life (any
    attempt's reply completes it) and resends only on a RETRYABLE reply, a
    failed send, a reset connection or a map that moves the target; and
    the PG runs a copy of an op whose first copy is still queued or
    running only by waiting for that copy's result.  The reference
    resends every 5 s and queues each copy behind the same PG lock, the
    resend storm that wedged 11a's ops on slow hosts.

And one CephFS's drive found through the mgr's balancer:

11. an EC shard rebuilt by recovery or backfill carries the object's user
    xattrs beside its identity xattrs: a shard an upmap moves to another
    OSD no longer loses them (the reference pushes the identity xattrs
    only, so a moved primary answers ENODATA and a striped file's size
    reads 0).

The map-change stall (the shared table, one upload of the weights, one
copy back a build) has its own file, ``test_torch_map_change.py``.
"""

import asyncio
import time

import pytest

from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.client.objecter import Objecter
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.mon.osdmap import Incremental, OSDMap
from ceph_tpu_torch.msg import Message, Messenger
from ceph_tpu_torch.msg import messenger as msgr_mod
from ceph_tpu_torch.osd import OSD
from ceph_tpu_torch.osd.backend import pack_mutations
from ceph_tpu_torch.osd.pg import PG


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _wait(cond, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.05)


# -- 1: the fence trusts the connection, not the reqid ----------------------

async def _raw_op(client: Messenger, mon: Monitor, reqid, tid: int,
                  data: bytes) -> dict:
    """One writefull to the primary of ``obj`` in pool "p", with the
    given reqid; returns the reply's data."""
    omap = mon.osdmap
    pool_id = omap.pool_names["p"]
    _, ps = omap.object_to_pg(pool_id, "obj")
    primary = omap.pg_primary(omap.pg_to_up_acting_osds(pool_id, ps))
    q: asyncio.Queue = asyncio.Queue()

    async def d(conn, msg):
        if msg.type == "osd_op_reply" and msg.data.get("tid") == tid:
            await q.put(msg.data)

    client.add_dispatcher(d)
    try:
        await client.send(tuple(omap.osds[primary].addr), f"osd.{primary}",
                          Message("osd_op", {
                              "pgid": omap.pg_name(pool_id, ps),
                              "oid": "obj", "reqid": reqid, "tid": tid,
                              "ops": [{"op": "writefull",
                                       "data": data}]}))
        return await asyncio.wait_for(q.get(), 15)
    finally:
        client.dispatchers.remove(d)


@pytest.mark.parametrize("by", ["instance", "entity"])
def test_fenced_client_stamping_another_reqid_is_refused(by):
    async def main():
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1},
                      device="cpu")
        addr = await mon.start()
        mon.peer_addrs = [addr]
        osds = []
        for i in range(2):
            osd = OSD(host=f"h{i}", device="cpu")
            await osd.start(addr)
            osds.append(osd)
        admin = await Rados(addr, name="client.admin", device="cpu").connect()
        client = Messenger("client.x")
        await client.bind()
        try:
            await admin.mon_command("osd pool create",
                                    {"name": "p", "pg_num": 4, "size": 2})
            await _wait(lambda: all("p" in o.osdmap.pool_names
                                    for o in osds))
            mine = [f"client.x:{client.incarnation}", 1]
            other = ["client.y:0123456789abcdef", 2]
            ok = await _raw_op(client, mon, mine, 1, b"before")
            assert not ok.get("err"), ok
            # not fenced, but the reqid names another instance
            assert (await _raw_op(client, mon, other, 2, b"x"))[
                "err"].startswith("EPERM")
            iid = mine[0] if by == "instance" else "client.x"
            await admin.mon_command("osd blocklist",
                                    {"id": iid, "duration": 600})
            await _wait(lambda: all(o.osdmap.is_blocklisted(iid)
                                    for o in osds))
            for tid, reqid in ((3, other), (4, ["client.x:0", 4]),
                               (5, [mine[0], 5]), (6, None)):
                reply = await _raw_op(client, mon, reqid, tid, b"after")
                assert reply["err"] == "EBLOCKLISTED", (reqid, reply)
            # another client is not fenced by client.x's entry
            other_io = await admin.open_ioctx("p")
            await other_io.write_full("obj2", b"fine")
            assert await other_io.read("obj2") == b"fine"
        finally:
            await client.shutdown()
            await admin.shutdown()
            for o in osds:
                await o.stop()
            await mon.stop()
    run(main())


# -- 2: the map's entries fence, not the OSD's clock ------------------------

def test_blocklist_entry_fences_until_the_monitor_removes_it(monkeypatch):
    m = OSDMap(device="cpu")
    inc = Incremental(epoch=m.epoch + 1)
    inc.new_blocklist["client.x:abc"] = time.time() + 5.0
    m.apply_incremental(inc)
    assert m.is_blocklisted("client.x:abc")
    assert not m.is_blocklisted("client.x:other")
    # this daemon's clock runs an hour past the expiry: still fenced
    later = time.time() + 3600.0
    monkeypatch.setattr(time, "time", lambda: later)
    assert m.is_blocklisted("client.x:abc")
    # the monitor's tick sweeps the expired entry out by an incremental
    inc = Incremental(epoch=m.epoch + 1)
    inc.old_blocklist.append("client.x:abc")
    m.apply_incremental(inc)
    assert not m.is_blocklisted("client.x:abc")


# -- 3: the hello's flags are MAC'd ------------------------------------------

async def _proxy(target, strip: bool):
    """A man in the middle on loopback: forwards both ways and, with
    ``strip``, clears HELLO_ACCEPTS_TICKETS in the server's hello (byte 20
    of the server-to-client stream: magic, 16-byte nonce, flags)."""
    async def pump(reader, writer, edit):
        seen = 0
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                if edit and seen <= 20 < seen + len(chunk):
                    b = bytearray(chunk)
                    b[20 - seen] &= ~msgr_mod.HELLO_ACCEPTS_TICKETS & 0xFF
                    chunk = bytes(b)
                seen += len(chunk)
                writer.write(chunk)
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def on_accept(c_reader, c_writer):
        s_reader, s_writer = await asyncio.open_connection(*target)
        asyncio.ensure_future(pump(c_reader, s_writer, False))
        asyncio.ensure_future(pump(s_reader, c_writer, strip))

    server = await asyncio.start_server(on_accept, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[:2]


@pytest.mark.parametrize("strip", [False, True])
def test_hello_flags_are_bound_into_the_negotiation_mac(strip):
    async def main():
        secret = b"k" * 32
        server = Messenger("svc.b", secret=secret)

        def validator(gen, blob):
            raise ValueError("no ticket here")
        server.ticket_validator = validator     # advertises tickets
        addr = await server.bind()
        proxy, paddr = await _proxy(addr, strip)
        client = Messenger("client.a", secret=secret)
        try:
            if strip:
                with pytest.raises(ValueError, match="MAC"):
                    await asyncio.wait_for(client.connect(paddr, "svc.b"),
                                           10)
            else:
                conn = await asyncio.wait_for(client.connect(paddr, "svc.b"),
                                              10)
                assert not conn.closed
        finally:
            await client.shutdown()
            await server.shutdown()
            proxy.close()
    run(main())


def test_the_mac_covers_each_flag():
    m = Messenger("svc.c", secret=b"s" * 32)
    nego = {"compression": "", "secure": False, "salt": "00" * 16}
    nonce, cnonce = b"n" * 16, b"c" * 16
    macs = {m._nego_mac(nego, nonce, cnonce, flags=f) for f in range(4)}
    assert len(macs) == 4
    assert Messenger("svc.d")._nego_mac(nego, nonce, cnonce, flags=1) == ""


# -- 4: EOF in the handshake is a failed connection ----------------------------

def test_a_peer_closing_mid_handshake_is_a_connection_error():
    async def main():
        async def slam(reader, writer):
            writer.close()
        server = await asyncio.start_server(slam, "127.0.0.1", 0)
        addr = server.sockets[0].getsockname()[:2]
        client = Messenger("osd.1")
        try:
            with pytest.raises(ConnectionError, match="during the handshake"):
                await asyncio.wait_for(client.connect(addr, "osd.2"), 10)
            with pytest.raises(ConnectionError):
                await asyncio.wait_for(client.send(
                    addr, "osd.2", Message("osd_ping", {})), 10)
        finally:
            await client.shutdown()
            server.close()
    run(main())


# -- 5: the shared map fetch outlives a cancelled caller -----------------------

def test_a_cancelled_caller_leaves_the_shared_map_fetch_to_the_others():
    async def main():
        obj = Objecter("client.t", device="cpu")
        fetched = asyncio.Event()

        async def slow_fetch(timeout=10):
            await asyncio.sleep(0.2)
            fetched.set()
        obj._refresh_map_once = slow_fetch
        owner = asyncio.ensure_future(obj._refresh_map())
        await asyncio.sleep(0.02)
        other = asyncio.ensure_future(obj._refresh_map())
        await asyncio.sleep(0.02)
        owner.cancel()
        await asyncio.wait_for(other, 5)
        assert fetched.is_set() and owner.cancelled()
        assert obj._refresh_inflight is None
        await obj.shutdown()
    run(main())


# -- 6: a cancelled op keeps the PG lock's count straight -------------------

@pytest.mark.parametrize("holder_releases", ["before_cancel", "after_cancel"])
def test_a_cancelled_op_leaves_the_pg_lock_as_it_found_it(holder_releases):
    """An op waits in ``_yield_to_commits`` on a pending commit of its
    object; the commit lands while another task holds the PG lock, so the op
    waits to take the lock back, and is cancelled there.  It must end
    cancelled, the other holder's release must succeed, and the lock must
    be free at the end and taken by the next op."""
    async def scenario():
        gate = asyncio.get_running_loop().create_future()
        pg = type("PGStandIn", (), {})()
        pg.lock = asyncio.Lock()
        pg._obj_commits = {"obj": gate}
        entered = asyncio.Event()

        async def op():
            async with pg.lock:
                entered.set()
                await PG._yield_to_commits(pg, "obj")

        task = asyncio.ensure_future(op())
        await entered.wait()
        await asyncio.sleep(0)          # the op has released, waits on gate
        await pg.lock.acquire()         # another op takes the PG
        gate.set_result(None)           # the commit lands
        for _ in range(3):
            await asyncio.sleep(0)      # the op now waits for the lock
        assert not task.done()
        if holder_releases == "before_cancel":
            task.cancel()
            await asyncio.sleep(0)
            pg.lock.release()
        else:
            pg.lock.release()
            task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert not pg.lock.locked()
        await asyncio.wait_for(pg.lock.acquire(), 1)
        pg.lock.release()
    run(scenario())


# -- 7: a heartbeat peer that enters the set starts a fresh clock -----------

def test_a_peer_entering_the_heartbeat_set_starts_a_fresh_clock():
    """Peers 1 and 2, then 1 and 3: osd.3's stamp is from long before it
    entered (it was a ring neighbour at boot), so judging it by that stamp
    would report it at once.  It must not be reported within the grace;
    osd.1, in the set all along and silent past the grace, still is."""
    async def scenario():
        osd = OSD(host="h", device="cpu")
        osd.whoami = 0
        grace = osd.config["osd_heartbeat_grace"]
        peers = [1, 2]
        reports = []

        async def ping(o, now):
            pass

        async def failover(msg):
            reports.append(msg.data["target"])
        osd._heartbeat_peers = lambda: list(peers)
        osd._ping_one = ping
        osd._mon_send_failover = failover
        osd._last_map_time = time.monotonic()
        await osd._heartbeat_once()
        assert reports == []
        stale = time.monotonic() - 10 * grace
        osd._hb_last[1] = stale          # silent past the grace, in the set
        osd._hb_last[3] = stale          # last heard before it left the set
        peers[:] = [1, 3]
        await osd._heartbeat_once()
        assert reports == [1]
    run(scenario())


# -- 8: the object map keeps every mark under concurrent writes -------------

def test_object_map_marks_every_object_written_in_flight_together():
    """16 writes to 16 objects at once on a fresh object-map image: every
    object reads EXISTS and ``disk_usage`` counts all 16."""
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd.features import OBJ_EXISTS, disk_usage

    async def scenario():
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1},
                      device="cpu")
        addr = await mon.start()
        mon.peer_addrs = [addr]
        osds = []
        for i in range(2):
            osds.append(OSD(host=f"h{i}", device="cpu"))
            await osds[-1].start(addr)
        r = await Rados(addr, device="cpu").connect()
        try:
            await r.pool_create("rbd", pg_num=8, size=2)
            io = await r.open_ioctx("rbd")
            order, n = 14, 16
            await RBD().create(io, "img", n << order, order=order,
                               features=["layering", "exclusive-lock",
                                         "object-map"])
            img = await Image.open(io, "img")
            await asyncio.wait_for(asyncio.gather(*(
                img.write(i << order, b"x" * 100) for i in range(n))), 30)
            assert list(await img.object_map.states()) == [OBJ_EXISTS] * n
            await img.close()
            img = await Image.open(io, "img")
            assert (await disk_usage(img))["used"] == n << order
            await img.close()
        finally:
            await r.shutdown()
            for o in osds:
                await o.stop()
            await mon.stop()
    run(scenario())


@pytest.mark.parametrize("when", ["trim", "activation"])
def test_write_caps_granted_while_the_mds_rejournals_them(when):
    """A write cap granted, and another released, while the MDS journals
    its custody: the trimming mutation (or the activation) completes, the
    released cap is not journaled again, and the grant journals itself."""
    from ceph_tpu_torch.mds import server

    mds = server.MDS(name="a", device="cpu")
    journaled = []

    class Journal:
        async def append(self, ev):
            journaled.append(ev)
            if len(journaled) == 2:       # while the re-journal awaits
                mds._apply_wcap("cap_grant_w", "client.x", 7, "x:1")
                mds._apply_wcap("cap_release_w", "client.x", 3, "x:1")
            await asyncio.sleep(0)

        async def trim(self):
            pass

    async def applied(ev, replay=False):
        pass

    mds.journal = Journal()
    mds._apply_event = applied
    mds._wcap_log = {"client.x": {"iid": "x:1", "inos": {1, 2, 3}}}
    if when == "trim":
        mds._events_since_trim = server.TRIM_EVERY - 1
        run(mds._journal_and_apply({"op": "noop"}))
        journaled.pop(0)                  # the event itself
    else:
        run(mds._rejournal_wcaps())
    assert [ev["ino"] for ev in journaled] == [1, 2]
    assert mds._wcap_log["client.x"]["inos"] == {1, 2, 7}


# -- 10: a busy PG's ops are neither resent on a timer nor run twice -----------

def _same_pg_oids(omap, pool_id: int, n: int) -> list[str]:
    """``n`` object names of pool ``pool_id`` that map to one PG."""
    by_pg: dict[str, list[str]] = {}
    for i in range(1000):
        oid = f"o{i}"
        pg = omap.pg_name(pool_id, omap.object_to_pg(pool_id, oid)[1])
        same = by_pg.setdefault(pg, [])
        same.append(oid)
        if len(same) == n:
            return same
    raise AssertionError("no PG holds enough names")


@pytest.mark.parametrize("sender", ["objecter", "resent_copies"])
def test_a_busy_pg_runs_each_op_once(sender):
    """The primary's PG lock is held while one write and one read wait
    for it.  ``objecter``: librados ops at the Objecter's settings, the
    lock held 6.5 s, past the 5 s at which an attempt used to time out and
    be resent; each op reaches the primary once, its one reply completes
    it, inside the 30 s op timeout.  ``resent_copies``: two
    copies of each op with one reqid (a resend) reach the PG while the
    lock is held; each op runs once and both copies are answered alike."""
    async def main():
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1},
                      device="cpu")
        addr = await mon.start()
        mon.peer_addrs = [addr]
        osds = []
        for i in range(2):
            osd = OSD(host=f"h{i}", device="cpu")
            await osd.start(addr)
            osds.append(osd)
        rados = await Rados(addr, name="client.admin", device="cpu").connect()
        raw = Messenger("client.raw")
        await raw.bind()
        try:
            await rados.mon_command("osd pool create",
                                    {"name": "p", "pg_num": 4, "size": 2})
            await _wait(lambda: all("p" in o.osdmap.pool_names
                                    for o in osds))
            io = await rados.open_ioctx("p")
            omap = mon.osdmap
            pool_id = omap.pool_names["p"]
            w_oid, r_oid = _same_pg_oids(omap, pool_id, 2)
            await io.write_full(r_oid, b"read me")
            _, ps = omap.object_to_pg(pool_id, w_oid)
            pgid = omap.pg_name(pool_id, ps)
            primary = omap.pg_primary(omap.pg_to_up_acting_osds(pool_id, ps))
            posd = next(o for o in osds if o.whoami == primary)
            await _wait(lambda: posd._get_pg(pgid) is not None
                        and posd._get_pg(pgid).state == "active")
            pg = posd._get_pg(pgid)
            arrived: dict[str, int] = {}
            runs: dict[str, int] = {}
            do_osd_op, do_read, do_writes = (posd._do_osd_op, pg._do_read_op,
                                             pg._do_writes)

            async def count_arrival(conn, msg):
                oid = msg.data.get("oid")
                arrived[oid] = arrived.get(oid, 0) + 1
                return await do_osd_op(conn, msg)

            async def count_read(oid, op):
                runs[oid] = runs.get(oid, 0) + 1
                return await do_read(oid, op)

            async def count_writes(oid, writes, *args, **kw):
                runs[oid] = runs.get(oid, 0) + 1
                return await do_writes(oid, writes, *args, **kw)

            posd._do_osd_op = count_arrival
            pg._do_read_op = count_read
            pg._do_writes = count_writes
            t0 = time.monotonic()
            await pg.lock.acquire()
            try:
                if sender == "objecter":
                    ob = rados.objecter
                    ops = [asyncio.ensure_future(ob.op_submit(
                        pool_id, oid, o, timeout=30))
                        for oid, o in (
                            (w_oid, [{"op": "writefull", "data": b"new"}]),
                            (r_oid, [{"op": "read", "off": 0, "len": None}]))]
                else:
                    peer = (tuple(omap.osds[primary].addr), f"osd.{primary}")
                    replies: dict[int, dict] = {}

                    async def on_reply(conn, msg):
                        if msg.type == "osd_op_reply":
                            replies[msg.data["tid"]] = msg

                    raw.add_dispatcher(on_reply)
                    me = f"client.raw:{raw.incarnation}"
                    for tid, oid, reqid, o in (
                            (1, w_oid, [me, 1],
                             [{"op": "writefull", "data": b"new"}]),
                            (2, r_oid, [me, 2],
                             [{"op": "read", "off": 0, "len": None}]),
                            (3, w_oid, [me, 1],
                             [{"op": "writefull", "data": b"new"}]),
                            (4, r_oid, [me, 2],
                             [{"op": "read", "off": 0, "len": None}])):
                        meta, segs = pack_mutations(o)
                        await raw.send(*peer, Message("osd_op", {
                            "pgid": pgid, "oid": oid, "ops": meta,
                            "tid": tid, "reqid": reqid}, segments=segs))
                    await _wait(lambda: arrived.get(w_oid) == 2
                                and arrived.get(r_oid) == 2)
                await asyncio.sleep(6.5 if sender == "objecter" else 3.5)
            finally:
                pg.lock.release()
            if sender == "objecter":
                wrote, read = await asyncio.wait_for(asyncio.gather(*ops), 30)
                assert "err" not in wrote.data, wrote.data
                assert read.segments[0] == b"read me"
                assert arrived == {w_oid: 1, r_oid: 1}, arrived
            else:
                await _wait(lambda: len(replies) == 4)
                for a, b in ((1, 3), (2, 4)):
                    assert "err" not in replies[a].data, replies[a].data
                    assert replies[a].data["results"] == \
                        replies[b].data["results"]
                    assert replies[a].segments == replies[b].segments
                assert replies[2].segments[0] == b"read me"
            assert runs == {w_oid: 1, r_oid: 1}, runs
            assert time.monotonic() - t0 < 30
            assert await io.read(w_oid) == b"new"
        finally:
            await raw.shutdown()
            await rados.shutdown()
            for o in osds:
                await o.stop()
            await mon.stop()
    run(main())


# -- 11: a rebuilt EC shard keeps the object's user xattrs --------------------

def test_an_upmapped_ec_shard_keeps_the_user_xattrs():
    """An EC 2+1 object with a user xattr; an upmap moves its primary
    shard to the fourth OSD, which rebuilds it from the others.  The new
    holder stores the xattr beside the identity ones, and the client reads
    it (served by the new primary) and the object back."""
    async def main():
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1},
                      device="cpu")
        addr = await mon.start()
        mon.peer_addrs = [addr]
        osds = []
        for i in range(4):
            osd = OSD(host=f"h{i}", device="cpu")
            await osd.start(addr)
            osds.append(osd)
        rados = await Rados(addr, device="cpu").connect()
        try:
            await rados.mon_command("osd erasure-code-profile set", {
                "name": "ec21", "profile": {"plugin": "cuda", "k": "2",
                                            "m": "1"}})
            await rados.pool_create("ec", pg_num=1, pool_type="erasure",
                                    erasure_code_profile="ec21")
            io = await rados.open_ioctx("ec")
            await io.write_full("obj", b"x" * 10000)
            await io.set_xattr("obj", "striper.size", b"10000")
            omap = mon.osdmap
            pool_id = omap.pool_names["ec"]
            pgid = omap.pg_name(pool_id, 0)
            acting = omap.pg_to_up_acting_osds(pool_id, 0)
            spare = next(o.whoami for o in osds if o.whoami not in acting)
            await rados.mon_command("osd pg-upmap-items", {
                "pgid": pgid, "mappings": [[acting[0], spare]]})
            await _wait(lambda: mon.osdmap.pg_to_up_acting_osds(
                pool_id, 0)[0] == spare)
            new = next(o for o in osds if o.whoami == spare)
            coll = f"pg_{pgid}"
            await _wait(lambda: new.store.exists(coll, "obj")
                        and not any(o.has_pending_recovery() for o in osds),
                        timeout=40)
            assert new.store.getattr(coll, "obj", "striper.size") == b"10000"
            assert await io.get_xattr("obj", "striper.size") == b"10000"
            assert await io.read("obj") == b"x" * 10000
        finally:
            await rados.shutdown()
            for o in osds:
                await o.stop()
            await mon.stop()

    run(asyncio.wait_for(main(), 120))
