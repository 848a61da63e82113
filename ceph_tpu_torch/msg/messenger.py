"""Asyncio messenger with lossless-client reconnect semantics.

Responsibilities mirrored from the reference's AsyncMessenger
(src/msg/async/AsyncMessenger.h:74): bind/accept, connect-by-address with
connection caching, ordered per-connection delivery with sequence numbers,
resend of unacked messages after reconnect (lossless policy,
src/msg/Policy.h), dispatcher fan-out, and an HMAC-SHA256 session
handshake standing in for cephx (src/auth/cephx) in crc mode.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import os
import struct
import time
from collections import deque
from typing import Awaitable, Callable

from .message import Message, read_frame, wrap_frame

Dispatcher = Callable[["Connection", Message], Awaitable[None]]

HELLO_MAGIC = b"CTHL"
HELLO_ACCEPTS_TICKETS = 0x01     # server can validate cephx tickets
HELLO_REQUIRES_TICKET = 0x02     # server will NACK ticketless peers

# flow-control policy (src/msg/Policy.h throttler analog): receivers ack
# delivered seqs every ack_every messages or ack_bytes payload bytes --
# and on a short idle timer, so a sender whose window is smaller than
# the peer's batching cadence still gets unblocked -- and senders block
# in send() once the unacked window exceeds the messenger's
# max_unacked_msgs/max_unacked_bytes instead of growing without bound.
ACK_EVERY = 64
ACK_BYTES = 8 << 20
ACK_FLUSH_S = 0.2
ACK_TYPE = "__ack"

# per-peer sub-op coalescing (the PR-12 write pipeline): concurrent
# ops' sub-writes bound for the same peer inside one flush window ride
# ONE framed message instead of one send per shard -- one seq, one
# frame header, one syscall, one read-loop wakeup.  The receiver
# unpacks and dispatches the sub-messages in staging order, so
# per-peer FIFO (what keeps replica logs in version order) is exactly
# as strong as the unbatched path.
SUBOP_BATCH_TYPE = "__subop_batch"


class Connection:
    def __init__(self, messenger: "Messenger", peer_name: str,
                 reader, writer, *, outgoing: bool,
                 peer_addr: tuple[str, int] | None = None) -> None:
        self.messenger = messenger
        self.peer_name = peer_name
        # the peer messenger's incarnation, as its hello named it (set
        # on accepted connections): with peer_name, the instance a
        # server fences
        self.peer_inst = ""
        self.reader = reader
        self.writer = writer
        self.outgoing = outgoing
        self.peer_addr = peer_addr
        self.out_seq = 0
        self.in_seq = 0
        self.unacked: deque[tuple[Message, int]] = deque()  # (msg, nbytes)
        self.unacked_bytes = 0
        self.acked_seq = 0           # peer-confirmed delivery watermark
        self._ack_pending_msgs = 0   # receive side: delivered since last ack
        self._ack_pending_bytes = 0
        self.closed = False
        self.generation = 0          # bumped per successful reconnect
        # negotiated on-wire transforms (ProtocolV2 compression_onwire
        # / crypto_onwire secure mode); set right after the handshake.
        # PER-DIRECTION AEAD keys: one shared key would let a recorded
        # client frame be reflected back to it as "authentic"
        self.compressor = None
        self.aead_tx = None
        self.aead_rx = None
        self._send_lock = asyncio.Lock()
        self._reconnect_lock = asyncio.Lock()
        self._window_open = asyncio.Event()
        self._window_open.set()
        self._read_task: asyncio.Task | None = None
        self._ack_timer: asyncio.TimerHandle | None = None

    def _window_full(self) -> bool:
        m = self.messenger
        return (len(self.unacked) >= m.max_unacked_msgs
                or self.unacked_bytes >= m.max_unacked_bytes)

    def _trim_acked(self, seq: int) -> None:
        if seq <= self.acked_seq:
            return
        self.acked_seq = seq
        while self.unacked and self.unacked[0][0].seq <= seq:
            _, nbytes = self.unacked.popleft()
            self.unacked_bytes -= nbytes
        if not self._window_full():
            self._window_open.set()

    async def send(self, msg: Message) -> None:
        if msg.type == ACK_TYPE:
            raise ValueError(f"{ACK_TYPE} is a reserved control frame type")
        faults = self.messenger.faults
        if faults is not None:
            fd = faults.on_send(self.messenger.name, self.peer_name,
                                msg.type)
            if fd.drop:
                return           # vanished on the wire (chaos drop)
            if fd.delay > 0:
                await asyncio.sleep(fd.delay)
            for _ in range(fd.copies - 1):
                # duplicates take fresh seqs so the receiver's replay
                # dedup does NOT absorb them -- handler idempotency is
                # exactly what the duplication fault probes
                await self._send_one(Message(msg.type, dict(msg.data),
                                             segments=list(msg.segments)))
        await self._send_one(msg)

    async def _send_one(self, msg: Message) -> None:
        while True:
            # window wait OUTSIDE the lock: _reconnect needs _send_lock
            # for the writer swap+replay, and the acks that reopen the
            # window need the reconnected stream -- a sender parked
            # here while holding the lock would deadlock the pair.
            st = await self._send_locked(msg)
            if st == "sent":
                return
            if st == "reconnect":
                # outside the send lock: _reconnect takes it for the
                # writer swap + replay, so the replayed frames cannot
                # interleave with other senders' writes
                await self.messenger._reconnect(self)
                return          # msg is in unacked; the replay sent it
            self._window_open.clear()
            await self._window_open.wait()
            if self.closed:
                raise ConnectionError(f"{self.peer_name} closed")

    async def _send_locked(self, msg: Message) -> str:
        """One locked send attempt: "sent" | "reconnect" | "window"
        ("window" = flow-control window full, caller waits UNLOCKED
        and retries -- K queued senders re-check here so they cannot
        overshoot the window by K-1)."""
        async with self._send_lock:
            if self.closed:
                raise ConnectionError(f"{self.peer_name} closed")
            if self._window_full():
                return "window"
            self.out_seq += 1
            msg.seq = self.out_seq
            msg.from_name = self.messenger.name
            buf = msg.encode()
            self.unacked.append((msg, len(buf)))
            self.unacked_bytes += len(buf)
            from .message import OFFLOAD_THRESHOLD
            if (self.compressor or self.aead_tx) \
                    and len(buf) > OFFLOAD_THRESHOLD:
                # multi-MB compress/encrypt off the event loop so
                # heartbeat handling doesn't stall behind it; ordering
                # is preserved -- we still hold the send lock, and a
                # reconnect cannot swap the writer or renegotiate keys
                # under us because its swap+replay also requires the
                # send lock.
                wire = await asyncio.get_event_loop().run_in_executor(
                    None, wrap_frame, buf, self.compressor,
                    self.aead_tx)
                if self.closed:
                    raise ConnectionError(f"{self.peer_name} closed")
            else:
                wire = wrap_frame(buf, self.compressor, self.aead_tx)
            from ..common.throttle import injector as _fault
            if _fault.check("ms_inject_socket_failures"):
                # chaos: drop the transport mid-send; the lossless
                # reconnect+replay machinery must absorb it
                # (ms_inject_socket_failures, qa msgr-failures suites)
                self.writer.close()
            try:
                self.writer.write(wire)
                await self.writer.drain()
                return "sent"
            except (ConnectionError, OSError):
                if not self.outgoing:
                    await self.close()
                    raise
                return "reconnect"

    def _note_delivered(self, nbytes: int) -> None:
        """Receive side: count a delivery toward the ack cadence and
        confirm immediately once the cadence is hit (a lost ack is
        re-covered by the next one or the reconnect handshake)."""
        self._ack_pending_msgs += 1
        self._ack_pending_bytes += nbytes
        if (self._ack_pending_msgs >= self.messenger.ack_every
                or self._ack_pending_bytes >= self.messenger.ack_bytes):
            self._flush_ack()
        elif self._ack_timer is None:
            # idle flush: a sender with a window smaller than our
            # batching cadence must still see acks eventually (a timer,
            # not a task: an in-process cluster arms thousands a second)
            self._ack_timer = asyncio.get_running_loop().call_later(
                ACK_FLUSH_S, self._ack_timeout)

    def _flush_ack(self) -> None:
        self._ack_pending_msgs = 0
        self._ack_pending_bytes = 0
        ack = Message(ACK_TYPE, {"seq": self.in_seq})
        ack.from_name = self.messenger.name
        try:
            self.writer.write(wrap_frame(ack.encode(), None,
                                         self.aead_tx))
        except (ConnectionError, OSError):
            pass

    def _ack_timeout(self) -> None:
        self._ack_timer = None
        if not self.closed and self._ack_pending_msgs:
            self._flush_ack()

    async def _resend_unacked(self) -> None:
        for msg, _ in list(self.unacked):
            self.writer.write(wrap_frame(msg.encode(), self.compressor,
                                         self.aead_tx))
        await self.writer.drain()

    async def close(self) -> None:
        self.closed = True
        self._window_open.set()      # wake throttled senders to error out
        if self._read_task:
            self._read_task.cancel()
        if self._ack_timer:
            self._ack_timer.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


def pack_subop_batch(msgs: list[Message]) -> Message:
    """Fold staged sub-op messages into ONE framed flush: metas carry
    each sub-message's (type, data, segment count); the segment lists
    concatenate in order.  Seq/ack/replay accounting all happen on the
    outer frame -- a reconnect replays the whole flush, the receiver
    dedups it as one unit, and unpacking restores staging order."""
    metas = [{"t": m.type, "d": m.data, "n": len(m.segments)}
             for m in msgs]
    segments: list[bytes] = []
    for m in msgs:
        segments.extend(m.segments)
    return Message(SUBOP_BATCH_TYPE, {"metas": metas},
                   segments=segments)


def unpack_subop_batch(msg: Message) -> list[Message]:
    out: list[Message] = []
    off = 0
    for meta in msg.data.get("metas", []):
        n = int(meta.get("n", 0))
        sub = Message(meta["t"], meta["d"],
                      segments=list(msg.segments[off:off + n]))
        off += n
        sub.seq = msg.seq            # dedup identity is the frame's
        sub.from_name = msg.from_name
        out.append(sub)
    return out


class SubOpPipe:
    """Per-peer sub-op coalescing with a flush window.

    ``stage()`` parks an outbound message (synchronously -- staging
    order IS the wire order, which is what keeps replica logs applied
    in version order) on its peer's queue; ONE ship worker per peer
    drains that queue, coalescing everything staged since its last
    cycle into one ``pack_subop_batch`` frame.  The flush window is
    an event-loop pass (the codec batcher's Nagle-off discipline) --
    and under backpressure it widens NATURALLY: while a ship is in
    flight the queue keeps growing, and the next cycle carries the
    whole backlog in one frame.

    Per-peer workers are a liveness requirement, not an optimization:
    a single drain loop awaiting sends inline lets one dead peer's
    reconnect backoff head-of-line-block every other peer's commits
    -- observed at 64 OSDs as cluster-wide wedged ops the moment one
    OSD died.  A slow peer now stalls only its own queue, and a send
    failure fails exactly that peer's staged ``on_error`` hooks (the
    op layer sees the same per-send errors as the unbatched path).

    With a fault injector attached, messages ship INDIVIDUALLY: the
    injector's drop/delay/dup rules key on the logical message type,
    and hiding sub-ops inside a batch frame would blind the chaos
    harness to them (the kill-mid-pipeline tests depend on per-subop
    fault fidelity).
    """

    def __init__(self, messenger: Messenger, *,
                 flush_window: float = 0.002, perf=None) -> None:
        self.messenger = messenger
        self.flush_window = float(flush_window)
        self.perf = perf
        # peer -> deque of (addr, msg, on_error)
        self._peer_q: dict[str, deque] = {}
        self._peer_tasks: dict[str, asyncio.Task] = {}
        # peer -> a ship cycle is running (inline flush_now or the
        # worker task); the flag is the one-shipper-per-peer mutex
        # that keeps frames in staging order
        self._busy: dict[str, bool] = {}
        self._n_staged = 0
        self.closed = False

    def stage(self, addr: tuple[str, int], peer_name: str,
              msg: Message, on_error=None) -> None:
        """Park one sub-op send; the peer's ship worker flushes it.

        Shipping ALWAYS happens on the worker task, never inline in
        the staging caller: the op path stages while holding its PG
        lock, and an inline send to a dead peer would hold that lock
        across the reconnect backoff (the degraded-phase collapse the
        pipeline exists to prevent)."""
        if self.closed:
            raise ConnectionError("subop pipe closed")
        q = self._peer_q.setdefault(peer_name, deque())
        q.append((tuple(addr), msg, on_error))
        self._n_staged += 1
        if self._busy.get(peer_name):
            return               # the live ship cycle carries it
        t = self._peer_tasks.get(peer_name)
        if t is None or t.done():
            self._peer_tasks[peer_name] = asyncio.ensure_future(
                self.arm_flush_window(peer_name))

    async def arm_flush_window(self, peer: str) -> None:
        """The ship worker (one per peer, retires when the queue
        drains; ``stage`` re-arms).  One coalescing pass first:
        every already-runnable co-submitter stages during it."""
        if self._busy.get(peer):
            return
        try:
            if self.flush_window > 0:
                await asyncio.sleep(0)   # co-submitters stage here
            await self._ship_loop(peer)
        except asyncio.CancelledError:
            if not self._busy.get(peer):
                await self._ship_loop(peer)   # shutdown: ship now

    async def _ship_loop(self, peer: str) -> None:
        """Ship until the peer's queue drains.  Sole shipper: the
        _busy flag serializes cycles, so frames leave in staging
        order even when flush_now and the worker race."""
        q = self._peer_q.get(peer)
        if q is None:
            return
        self._busy[peer] = True
        try:
            while q:
                await self._ship_queued(peer, q)
        finally:
            self._busy[peer] = False

    async def _ship_queued(self, peer: str, q: deque) -> None:
        if not q:
            return
        entries = list(q)
        q.clear()
        self._n_staged -= len(entries)
        if self.perf is not None:
            self.perf.inc("flush_windows")
        addr = entries[0][0]
        msgs = [m for _, m, _ in entries]
        try:
            if len(msgs) == 1 or self.messenger.faults is not None:
                for a, m, _ in entries:
                    await self.messenger.send(a, peer, m)
            else:
                await self.messenger.send(addr, peer,
                                          pack_subop_batch(msgs))
                if self.perf is not None:
                    self.perf.inc("coalesced_subops", len(msgs))
        except (ConnectionError, OSError) as e:
            for _, _, on_error in entries:
                if on_error is not None:
                    on_error(e)

    async def close(self) -> None:
        """Ship anything parked, then refuse further staging -- a
        staged sub-op may never outlive the pipe (it would wedge the
        op awaiting its reply)."""
        self.closed = True
        for t in self._peer_tasks.values():
            t.cancel()
        self._peer_tasks.clear()
        for peer, q in list(self._peer_q.items()):
            if not self._busy.get(peer):
                await self._ship_queued(peer, q)


class Messenger:
    def __init__(self, name: str, secret: bytes | None = None, *,
                 max_unacked_msgs: int = 4096,
                 max_unacked_bytes: int = 64 << 20,
                 ack_every: int = ACK_EVERY,
                 ack_bytes: int = ACK_BYTES,
                 compression: str | None = None,
                 secure: bool = False,
                 faults=None) -> None:
        self.name = name
        self.secret = secret
        # deterministic message mangling (common/faults.py): consulted
        # on every app-level send and every delivered message; None in
        # production paths
        self.faults = faults
        # on-wire transforms this endpoint OFFERS/accepts; the server
        # picks during the handshake (ProtocolV2 negotiation)
        self.compression = compression
        self.secure = secure
        # secure mode needs a key source, but that can be the PSK OR a
        # cephx ticket/validator installed after construction; a
        # keyless endpoint that insists on secure simply refuses every
        # connection at negotiation time
        self.max_unacked_msgs = max_unacked_msgs
        self.max_unacked_bytes = max_unacked_bytes
        self.ack_every = ack_every
        self.ack_bytes = ack_bytes
        # incarnation distinguishes a restarted peer from a reconnecting
        # one (ProtocolV2's global_seq/connect_seq split): a new
        # incarnation resets the replay-dedup session, a reconnect of
        # the same incarnation resumes it
        self.incarnation = os.urandom(8).hex()
        # cephx ticket auth (composes with/replaces the static PSK,
        # src/auth/cephx/CephxProtocol.h): a CLIENT stores tickets per
        # target service in `tickets` ({"gen", "ticket", "session_key"
        # hex, "expires"}); connect() picks by the peer name's prefix
        # ("osd.3" -> tickets["osd"]) and proves the session key in
        # the handshake instead of the PSK.  A SERVER sets
        # `ticket_validator(gen, blob_hex) -> session_key bytes`
        # (raises to reject); the validated session key becomes the
        # connection secret for the proof, negotiation MAC, and
        # secure-mode AEAD keys, so a leaked PSK stops being forever.
        # `require_ticket` makes the server NACK
        # peers that present no (or a bad) ticket.
        self.tickets: dict[str, dict] = {}
        self.ticket_validator = None
        self.require_ticket = False
        self.dispatchers: list[Dispatcher] = []
        # ms_fast_dispatch analog: a SYNCHRONOUS handler consulted
        # before the task-per-message dispatch path.  Returning True
        # consumes the message without spawning a task -- reply
        # messages that only resolve a tid waiter (the bulk of sub-op
        # traffic) skip a whole scheduling quantum each.  Fault
        # delays/duplicates still take the task path so chaos timing
        # semantics are unchanged.
        self.fast_dispatch = None
        # one connection per peer per DIRECTION: simultaneous cross-
        # connects between two daemons are legal and never race over a
        # shared slot (the reference arbitrates the same race with
        # ProtocolV2 global_seq; separate directions sidestep it)
        self.conns: dict[str, Connection] = {}       # outgoing, by peer
        self.conns_in: dict[str, Connection] = {}    # accepted, by peer
        # per-peer last delivered seq; survives reconnects so replayed
        # messages dedup (the lossless policy's session state)
        self._sessions: dict[str, int] = {}
        self._session_inst: dict[str, str] = {}      # peer -> incarnation
        self._connect_locks: dict[str, asyncio.Lock] = {}
        self._shutting_down = False
        self._server: asyncio.base_events.Server | None = None
        self.addr: tuple[str, int] | None = None
        self._accept_tasks: set[asyncio.Task] = set()

    # -- server -------------------------------------------------------------
    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._on_accept, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    def add_dispatcher(self, fn: Dispatcher) -> None:
        self.dispatchers.append(fn)

    async def _on_accept(self, reader, writer) -> None:
        if self._shutting_down:
            writer.close()
            return
        try:
            peer_name, inst, nego, hs_nonce, hs_cnonce, hs_secret = \
                await self._handshake_server_read(reader, writer)
        except (asyncio.IncompleteReadError, ValueError, ConnectionError):
            writer.close()
            return
        if self._shutting_down:      # raced shutdown during handshake
            writer.close()
            return
        # close any stale conn from this peer BEFORE touching session
        # state: its read loop must not repopulate _sessions with an
        # old seq between our reset and the in_seq snapshot below
        old = self.conns_in.get(peer_name)
        if old is not None:
            await old.close()
        if self._session_inst.get(peer_name) != inst:
            # restarted peer: fresh session, no replay dedup state
            self._session_inst[peer_name] = inst
            self._sessions.pop(peer_name, None)
        last_seq = self._sessions.get(peer_name, 0)
        try:
            nego_blob = json.dumps(nego).encode()
            writer.write(b"ACK!" + struct.pack("<Q", last_seq)
                         + struct.pack("<I", len(nego_blob)) + nego_blob)
            await writer.drain()
        except (ConnectionError, OSError):
            writer.close()
            return
        conn = Connection(self, peer_name, reader, writer, outgoing=False)
        conn.peer_inst = inst
        self._apply_negotiation(conn, nego, hs_nonce, hs_cnonce,
                                is_server=True, secret=hs_secret)
        conn.in_seq = last_seq
        self.conns_in[peer_name] = conn
        conn._read_task = asyncio.ensure_future(self._read_loop(conn))

    # -- handshake (HMAC challenge, cephx-lite) ------------------------------
    def _ticket_for(self, peer_name: str) -> dict | None:
        """The live ticket for the peer's service class, if any
        (expired tickets are dropped -- the owner refreshes)."""
        service = peer_name.split(".", 1)[0]
        t = self.tickets.get(service)
        if t is not None and t.get("expires", 0) < time.time():
            del self.tickets[service]
            return None
        return t

    def _session_keys(self, nonce: bytes, cnonce: bytes, salt: bytes,
                      secret: bytes | None = None):
        """Per-direction session keys from the full transcript: server
        nonce + CLIENT nonce + salt (a replayed server hello cannot
        force key reuse -- the client's nonce is fresh), with a
        direction label (c2s/s2c) so the two streams never share a key
        (cephx-style session key into AES-GCM, crypto_onwire.cc).
        The AEAD comes from cephx._aes: real AES-GCM when the
        optional `cryptography` wheel is present, the stdlib fallback
        otherwise (both ends of a connection share the environment in
        tests, so the negotiated mode always matches)."""
        from ..common.cephx import _aes
        secret = secret if secret is not None else self.secret
        base = nonce + cnonce + salt

        def key(label: bytes):
            return _aes(hmac.new(secret,
                                 b"ctv2-secure-" + label + base,
                                 hashlib.sha256).digest())
        return key(b"c2s"), key(b"s2c")

    def _nego_mac(self, nego: dict, nonce: bytes,
                  cnonce: bytes, secret: bytes | None = None,
                  flags: int = 0) -> str:
        """Bind the negotiation to the shared secret: a MITM rewriting
        the plaintext nego blob (encryption downgrade) or the hello's
        flags byte (stripping HELLO_ACCEPTS_TICKETS downgrades a ticket
        client to the PSK) fails the MAC."""
        secret = secret if secret is not None else self.secret
        if secret is None:
            return ""
        blob = json.dumps({**{k: nego[k] for k in
                              ("compression", "secure", "salt")},
                           "flags": flags},
                          sort_keys=True).encode()
        return hmac.new(secret, b"nego" + nonce + cnonce + blob,
                        hashlib.sha256).hexdigest()

    def _negotiate(self, offered: dict,
                   secret: bytes | None = None) -> dict:
        """Server side: pick the on-wire transforms."""
        comp = ""
        if self.compression and self.compression in offered.get(
                "compress", []):
            comp = self.compression
        secure = bool(offered.get("secure")) and self.secure \
            and (secret if secret is not None
                 else self.secret) is not None
        return {"compression": comp, "secure": secure,
                "salt": os.urandom(16).hex()}

    async def _handshake_server_read(self, reader, writer):
        """Server side up to (not including) the ACK: returns
        (peer name, peer incarnation, negotiated transforms, nonce,
        cnonce, connection secret)."""
        nonce = os.urandom(16)
        # hello flags advertise ticket support so a ticket-holding
        # client talking to a PSK-only server falls back to the PSK
        # instead of proving a key the server can't derive
        flags = (HELLO_ACCEPTS_TICKETS
                 if self.ticket_validator is not None else 0) \
            | (HELLO_REQUIRES_TICKET if self.require_ticket else 0)
        writer.write(HELLO_MAGIC + struct.pack("<16sB", nonce, flags))
        await writer.drain()
        hdr = await reader.readexactly(4)
        if hdr != HELLO_MAGIC:
            raise ValueError("bad hello")
        (nlen,) = struct.unpack("<I", await reader.readexactly(4))
        payload = json.loads(await reader.readexactly(nlen))

        async def reject(why: str):
            writer.write(b"NACK")
            await writer.drain()
            raise ValueError(why)

        # cephx: a presented ticket, once validated against the
        # rotating service keys, carries the session key that becomes
        # THIS connection's secret (proof, nego MAC, AEAD) -- and its
        # sealed entity must MATCH the claimed peer name, or any
        # service-class ticket holder could impersonate any daemon
        secret = self.secret
        cephx = payload.get("cephx")
        if cephx is not None and self.ticket_validator is not None:
            try:
                info = self.ticket_validator(cephx["gen"],
                                             cephx["ticket"])
            except Exception as e:
                await reject(f"cephx ticket rejected: {e}")
            if info["entity"] != payload.get("name"):
                await reject(
                    f"ticket entity {info['entity']!r} does not match "
                    f"claimed name {payload.get('name')!r}")
            secret = info["session_key"]
        elif self.require_ticket:
            await reject("cephx ticket required")

        proof = bytes.fromhex(payload.get("proof", ""))
        if secret is not None:
            want = hmac.new(secret, nonce, hashlib.sha256).digest()
            if not hmac.compare_digest(proof, want):
                await reject("auth failure")
        nego = self._negotiate(payload, secret)
        if self.secure and not nego["secure"]:
            # the server's secure requirement binds BOTH directions: a
            # peer that won't (or can't) encrypt gets no session at all
            await reject("peer did not offer secure mode")
        cnonce = bytes.fromhex(payload.get("cnonce", "")) or b"\0" * 16
        nego["mac"] = self._nego_mac(nego, nonce, cnonce, secret, flags)
        return payload["name"], payload.get("inst", ""), nego, \
            nonce, cnonce, secret

    def _apply_negotiation(self, conn: Connection, nego: dict,
                           nonce: bytes, cnonce: bytes,
                           is_server: bool,
                           secret: bytes | None = None,
                           flags: int = 0) -> None:
        if conn.outgoing is is_server:
            raise ValueError("negotiation direction mismatch")
        secret = secret if secret is not None else self.secret
        # a RE-negotiation (reconnect) replaces the transforms wholesale:
        # keeping a stale compressor after the peer stopped offering it
        # would emit frames the peer can no longer parse
        conn.compressor = None
        conn.aead_tx = None
        conn.aead_rx = None
        if not is_server:
            # client: verify the server's pick against the transcript
            # MAC and refuse a downgrade of our secure requirement
            want = self._nego_mac(nego, nonce, cnonce, secret, flags)
            if want and not hmac.compare_digest(
                    want, nego.get("mac", "")):
                raise ValueError("negotiation MAC mismatch (tampered?)")
            if self.secure and not nego.get("secure"):
                raise ValueError(
                    "peer refused secure mode (downgrade rejected)")
        if nego.get("compression"):
            from ..compressor import Compressor, CompressorError
            try:
                conn.compressor = Compressor.create(nego["compression"])
            except CompressorError as e:
                # normalize to the error type every negotiation-failure
                # path already handles (close, don't retry)
                raise ValueError(str(e)) from e
        if nego.get("secure"):
            c2s, s2c = self._session_keys(nonce, cnonce,
                                          bytes.fromhex(nego["salt"]),
                                          secret)
            if is_server:
                conn.aead_rx, conn.aead_tx = c2s, s2c
            else:
                conn.aead_tx, conn.aead_rx = c2s, s2c

    async def _handshake_client(self, reader, writer,
                                peer_name: str = ""):
        """The client's side of the hello; a peer that closes the stream
        mid-handshake (a daemon shutting down accepts, then closes) is a
        failed connection, as a refused one is."""
        try:
            return await self._hello_client(reader, writer, peer_name)
        except asyncio.IncompleteReadError as e:
            writer.close()
            raise ConnectionError(f"{peer_name or 'peer'} closed the "
                                  f"connection during the handshake") from e

    async def _hello_client(self, reader, writer, peer_name: str):
        hdr = await reader.readexactly(21)
        if hdr[:4] != HELLO_MAGIC:
            raise ValueError("bad hello")
        nonce = hdr[4:20]
        flags = hdr[20]
        # a live ticket for the peer's service replaces the PSK: we
        # prove the ticket's session key, and the server recovers the
        # same key from the sealed ticket blob.  Only presented when
        # the server's hello says it can validate tickets (a PSK-only
        # server would otherwise fail our proof)
        secret = self.secret
        fields = {}
        ticket = (self._ticket_for(peer_name)
                  if peer_name and flags & HELLO_ACCEPTS_TICKETS
                  else None)
        if ticket is not None:
            secret = bytes.fromhex(ticket["session_key"])
            fields["cephx"] = {"gen": ticket["gen"],
                               "ticket": ticket["ticket"]}
        proof = b""
        if secret is not None:
            proof = hmac.new(secret, nonce, hashlib.sha256).digest()
        cnonce = os.urandom(16)
        payload = json.dumps({
            "name": self.name, "inst": self.incarnation,
            "proof": proof.hex(), "cnonce": cnonce.hex(),
            "compress": [self.compression] if self.compression else [],
            "secure": self.secure, **fields}).encode()
        writer.write(HELLO_MAGIC + struct.pack("<I", len(payload)) + payload)
        await writer.drain()
        ack = await reader.readexactly(4)
        if ack != b"ACK!":
            raise ConnectionError("auth rejected")
        (last_seq,) = struct.unpack("<Q", await reader.readexactly(8))
        (nego_len,) = struct.unpack("<I", await reader.readexactly(4))
        nego = json.loads(await reader.readexactly(nego_len))
        return last_seq, nego, nonce, cnonce, secret, flags

    # -- client -------------------------------------------------------------
    async def connect(self, addr: tuple[str, int],
                      peer_name: str) -> Connection:
        # serialize per peer: N concurrent sends must share ONE
        # connection, not race N handshakes (the acceptor keeps a single
        # incoming conn per peer and would drop the losers mid-flight)
        lock = self._connect_locks.setdefault(peer_name, asyncio.Lock())
        async with lock:
            replay: list[Message] = []   # unacked msgs carried over
            conn = self.conns.get(peer_name)
            if conn is not None and not conn.closed:
                if conn.outgoing and conn.peer_addr is not None \
                        and tuple(conn.peer_addr) != tuple(addr):
                    # peer rebound to a new address: the cached conn
                    # points at a dead endpoint; carry its unacked
                    # messages over (lossless policy)
                    replay = [m for m, _ in conn.unacked]
                    await conn.close()
                else:
                    return conn
            elif conn is not None and conn.closed:
                replay = [m for m, _ in conn.unacked]
            reader, writer = await asyncio.open_connection(
                addr[0], addr[1])
            last_seq, nego, hs_nonce, hs_cnonce, hs_secret, hs_flags = \
                await self._handshake_client(reader, writer, peer_name)
            conn = Connection(self, peer_name, reader, writer,
                              outgoing=True, peer_addr=addr)
            self._apply_negotiation(conn, nego, hs_nonce, hs_cnonce,
                                    is_server=False, secret=hs_secret,
                                    flags=hs_flags)
            # continue the server's seq space: a same-incarnation
            # session survives connection churn, and starting below
            # last_seq would get every message deduped as a replay
            conn.out_seq = last_seq
            self.conns[peer_name] = conn
            conn._read_task = asyncio.ensure_future(self._read_loop(conn))
            for msg in replay:
                if msg.seq > last_seq:
                    await conn.send(msg)     # re-stamps seq past last_seq
            return conn

    async def _reconnect(self, conn: Connection) -> None:
        """Lossless policy: reopen and replay unacked in order.

        Serialized per connection — the send error path and the
        read-loop EOF path can both request a reconnect concurrently;
        the second requester finds the generation already advanced and
        returns without racing reader/writer swaps.
        """
        if conn.peer_addr is None:
            await conn.close()
            raise ConnectionError("incoming connection lost")
        gen = conn.generation
        async with conn._reconnect_lock:
            if conn.closed:
                raise ConnectionError(f"{conn.peer_name} closed")
            if conn.generation != gen:
                return               # someone else already reconnected
            for attempt in range(5):
                try:
                    reader, writer = await asyncio.open_connection(
                        conn.peer_addr[0], conn.peer_addr[1])
                    (last_seq, nego, hs_nonce, hs_cnonce, hs_secret,
                     hs_flags) = await self._handshake_client(
                         reader, writer, conn.peer_name)
                    # swap + replay under the SEND lock: a sender mid-
                    # flight must not write a newer seq onto the fresh
                    # stream before the replay of older unacked frames
                    # (the receiver's dedup would then drop the older
                    # seq as a replay -> silent loss)
                    async with conn._send_lock:
                        self._apply_negotiation(conn, nego, hs_nonce,
                                                hs_cnonce,
                                                is_server=False,
                                                secret=hs_secret,
                                                flags=hs_flags)
                        conn._trim_acked(last_seq)
                        conn.reader, conn.writer = reader, writer
                        # server->client stream restarts on new accept
                        conn.in_seq = 0
                        conn.generation += 1
                        if conn._read_task:
                            conn._read_task.cancel()
                        conn._read_task = asyncio.ensure_future(
                            self._read_loop(conn))
                        await conn._resend_unacked()
                    return
                except (ConnectionError, OSError):
                    await asyncio.sleep(0.05 * (2 ** attempt))
                except ValueError:
                    # negotiation failure (MAC mismatch, downgrade,
                    # unknown compressor): retrying cannot help; close
                    # so connect() replaces the conn instead of
                    # returning a zombie forever
                    break
            await conn.close()
            raise ConnectionError(f"reconnect to {conn.peer_name} failed")

    async def send(self, addr: tuple[str, int], peer_name: str,
                   msg: Message) -> None:
        conn = await self.connect(addr, peer_name)
        await conn.send(msg)

    # -- dispatch -----------------------------------------------------------
    async def _read_loop(self, conn: Connection) -> None:
        try:
            while not conn.closed:
                buf = await read_frame(conn.reader, conn.compressor,
                                       conn.aead_rx)
                msg = Message.decode(buf)
                if msg.type == ACK_TYPE:   # control frame, outside seq space
                    conn._trim_acked(int(msg.data.get("seq", 0)))
                    continue
                if msg.seq <= conn.in_seq:
                    continue  # duplicate after resend
                conn.in_seq = msg.seq
                if not conn.outgoing:
                    self._sessions[conn.peer_name] = msg.seq
                conn._note_delivered(len(buf))
                if msg.type == SUBOP_BATCH_TYPE:
                    # one framed flush -> the staged sub-ops, delivered
                    # in staging order (per-peer FIFO preserved)
                    for sub in unpack_subop_batch(msg):
                        self._deliver(conn, sub)
                else:
                    self._deliver(conn, msg)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            if conn.outgoing and not conn.closed:
                # lossless policy: try to re-establish and replay
                # unacked; on failure the conn is closed so connect()
                # replaces it instead of returning a cached corpse
                try:
                    t = asyncio.ensure_future(self._try_reconnect(conn))
                    self._accept_tasks.add(t)
                    t.add_done_callback(self._accept_tasks.discard)
                except RuntimeError:      # event loop shutting down
                    conn.closed = True
                    conn._window_open.set()
            else:
                conn.closed = True
                # wake any sender blocked on the flow-control window so
                # it raises instead of hanging on a dead connection
                conn._window_open.set()
                try:
                    conn.writer.close()
                except Exception:
                    pass
        except asyncio.CancelledError:
            pass

    def _deliver(self, conn: Connection, msg: Message) -> None:
        """Fault-inject and dispatch ONE logical message (seq/ack
        accounting already ran on its frame)."""
        copies, delay = 1, 0.0
        if self.faults is not None:
            # recv-side injection happens ABOVE the transport:
            # seq/ack accounting already ran, so a dropped
            # message is "lost in the daemon", not a wire error
            # the lossless replay would transparently heal
            fd = self.faults.on_recv(
                self.name, conn.peer_name or msg.from_name,
                msg.type)
            if fd.drop:
                return
            copies, delay = fd.copies, fd.delay
        if (self.fast_dispatch is not None and copies == 1
                and delay == 0.0 and self.fast_dispatch(conn, msg)):
            return
        # dispatch in a task: a handler that itself RPCs back to
        # this peer must not block the read loop its reply rides
        # on (the reference's DispatchQueue decoupling).  Task
        # creation order preserves ordering for handlers'
        # synchronous prefixes.
        for _ in range(copies):
            t = asyncio.ensure_future(
                self._dispatch_one(conn, msg, delay))
            self._accept_tasks.add(t)
            t.add_done_callback(self._accept_tasks.discard)

    async def _try_reconnect(self, conn: Connection) -> None:
        try:
            await self._reconnect(conn)
        except (ConnectionError, OSError):
            pass

    async def _dispatch_one(self, conn: Connection, msg: Message,
                            delay: float = 0.0) -> None:
        if delay > 0:
            await asyncio.sleep(delay)
        for d in list(self.dispatchers):
            try:
                await d(conn, msg)
            except (ConnectionError, OSError):
                pass

    async def shutdown(self) -> None:
        # stop accepting BEFORE closing connections: closing a conn
        # triggers the peer's instant reconnect, and a still-open
        # listener would accept it -- a ghost connection that survives
        # shutdown and keeps this daemon answering (e.g. heartbeats
        # from a "dead" OSD, defeating failure detection)
        self._shutting_down = True
        if self._server is not None:
            self._server.close()
        for t in list(self._accept_tasks):
            t.cancel()
        for conn in (list(self.conns.values())
                     + list(self.conns_in.values())):
            await conn.close()
        self.conns.clear()
        self.conns_in.clear()
        if self._server is not None:
            # 3.12 wait_closed blocks until every peer transport is
            # gone; peers shutting down concurrently make that a
            # deadlock, so bound it
            try:
                await asyncio.wait_for(self._server.wait_closed(), 1.0)
            except asyncio.TimeoutError:
                pass
