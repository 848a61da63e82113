"""ClientSwarm: N concurrent librados users driving one op schedule.

Clients are coroutines over real ``IoCtx`` handles (client/rados.py →
Objecter → messenger), multiplexed over a configurable number of
Rados connections so the messenger layer sees realistic connection
fan-in.  Per-op latency goes into log-bucketed histograms per op
class — p50/p95/p99/p99.9 without storing a sample per op — and the
process-wide ``workload`` perf set (adopted into OSD perf dumps)
counts ops/bytes/errors.

Issue disciplines:

* closed loop — each client issues its next op when the previous one
  completes; with ``target_qps`` set, op i additionally never issues
  before ``t0 + i/qps`` (rate-limited closed loop, the convergence
  mode the tests pin);
* open loop — ops fire AT schedule time regardless of completions
  (queueing delay shows up as latency, not as reduced offered load),
  with a safety-valve in-flight cap whose stalls are counted, never
  hidden.

Port of ``ceph_tpu/loadgen/swarm.py``: the clients' librados handles
take the swarm's ``device`` (CUDA unless the caller names the CPU), the
cluster's.
"""

from __future__ import annotations

import asyncio
import time

from ..client.rados import IoCtx, Rados, RadosError
from ..client.objecter import ObjecterError
from ..common.config import ConfigProxy
from .histogram import LatencyHistogram
from .spec import KINDS, Op, WorkloadSpec, payload_for
from .stats import PERF


class PhaseResult:
    """One phase's outcome: deterministic tallies + measured timings."""

    def __init__(self, label: str) -> None:
        self.label = label
        self.hists = {k: LatencyHistogram() for k in KINDS}
        self.ops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.errors: list[dict] = []
        self.wedged = 0
        self.open_loop_stalls = 0
        self.elapsed = 0.0

    @property
    def failed(self) -> int:
        return len(self.errors)

    def to_dict(self) -> dict:
        total_bytes = self.bytes_read + self.bytes_written
        lat = {k: h.summary() for k, h in self.hists.items()
               if h.n}
        return {
            "label": self.label,
            "ops": self.ops,
            "failed_ops": self.failed,
            "wedged_ops": self.wedged,
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "open_loop_stalls": self.open_loop_stalls,
            "errors": self.errors[:16],      # first few, not megabytes
            "timing": {
                "elapsed_s": round(self.elapsed, 3),
                "ops_per_s": round(self.ops / self.elapsed, 1)
                if self.elapsed else 0.0,
                "GiBps": round(total_bytes / self.elapsed / 2**30, 4)
                if self.elapsed else 0.0,
                "latency": lat,
            },
        }


class ClientSwarm:
    def __init__(self, spec: WorkloadSpec, mon_addr,
                 conf: ConfigProxy | None = None, device=None) -> None:
        self.spec = spec
        self.mon_addr = tuple(mon_addr)
        self.conf = conf or ConfigProxy()
        self.device = device
        self.handles: list[Rados] = []
        self.ioctxs: list[IoCtx] = []
        self.op_timeout = float(self.conf.get("loadgen_op_timeout"))
        # called as on_wedged(op, io) when an op passes the deadline
        self.on_wedged = None

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        n = min(int(self.conf.get("loadgen_rados_handles")),
                max(1, self.spec.n_clients))
        for i in range(n):
            r = Rados(self.mon_addr, name=f"client.loadgen{i}",
                      device=self.device)
            await r.connect()
            self.handles.append(r)
        io0 = await self.handles[0].open_ioctx(self.spec.pool)
        self.ioctxs = [io0] + [
            IoCtx(r, self.spec.pool, io0.pool_id)
            for r in self.handles[1:]]

    async def shutdown(self) -> None:
        for r in self.handles:
            await r.shutdown()
        self.handles, self.ioctxs = [], []

    def _io(self, client_idx: int) -> IoCtx:
        return self.ioctxs[client_idx % len(self.ioctxs)]

    # -- one op -------------------------------------------------------------
    async def _do_op(self, op: Op, io: IoCtx,
                     res: PhaseResult) -> None:
        t0 = time.perf_counter()
        try:
            if op.kind == "read":
                data = await asyncio.wait_for(
                    io.read(op.oid), self.op_timeout)
                res.bytes_read += len(data)
                PERF.inc("bytes_read", len(data))
            elif op.kind == "write":
                await asyncio.wait_for(
                    io.write_full(op.oid,
                                  payload_for(self.spec, op.size)),
                    self.op_timeout)
                res.bytes_written += op.size
                PERF.inc("bytes_written", op.size)
            else:                      # rmw: partial overwrite
                await asyncio.wait_for(
                    io.write(op.oid, payload_for(self.spec, op.size),
                             offset=op.off),
                    self.op_timeout)
                res.bytes_written += op.size
                PERF.inc("bytes_written", op.size)
        except asyncio.TimeoutError:
            if self.on_wedged is not None:
                self.on_wedged(op, io)
            res.wedged += 1
            res.errors.append({"op": op.kind, "oid": op.oid,
                               "err": "WEDGED"})
            PERF.inc("op_wedged")
            PERF.inc("op_errors")
            return
        except (RadosError, ObjecterError, ConnectionError,
                OSError) as e:
            res.errors.append({"op": op.kind, "oid": op.oid,
                               "err": str(e)[:120]})
            PERF.inc("op_errors")
            return
        res.hists[op.kind].record(time.perf_counter() - t0)
        res.ops += 1
        PERF.inc(f"ops_{op.kind}")

    # -- phases -------------------------------------------------------------
    async def preload(self) -> PhaseResult:
        """Write the whole working set (the load phase)."""
        res = PhaseResult("load")
        sem = asyncio.Semaphore(
            int(self.conf.get("loadgen_preload_concurrency")))
        t0 = time.perf_counter()

        async def one(i: int, op: Op) -> None:
            async with sem:
                await self._do_op(op, self._io(i), res)

        await asyncio.gather(*(one(i, op) for i, op in
                               enumerate(self.spec.preload_ops())))
        res.elapsed = time.perf_counter() - t0
        return res

    async def run_phase(self, ops: list[Op], label: str,
                        mode: str | None = None,
                        target_qps: float | None = None) -> PhaseResult:
        mode = mode or self.spec.mode
        target_qps = (self.spec.target_qps if target_qps is None
                      else target_qps)
        if mode == "open":
            return await self._run_open(ops, label, target_qps)
        return await self._run_closed(ops, label, target_qps)

    async def _run_closed(self, ops: list[Op], label: str,
                          qps: float) -> PhaseResult:
        """N clients, each issuing when its previous op completes;
        with a QPS target, op i is additionally held until its
        schedule time t0 + i/qps."""
        res = PhaseResult(label)
        it = iter(enumerate(ops))
        t0 = time.perf_counter()

        async def client(idx: int) -> None:
            for i, op in it:
                if qps > 0:
                    due = t0 + i / qps
                    delay = due - time.perf_counter()
                    if delay > 0:
                        await asyncio.sleep(delay)
                await self._do_op(op, self._io(idx), res)

        await asyncio.gather(*(client(c)
                               for c in range(self.spec.n_clients)))
        res.elapsed = time.perf_counter() - t0
        return res

    async def _run_open(self, ops: list[Op], label: str,
                        qps: float) -> PhaseResult:
        """Dispatch at schedule time, completions decoupled: queueing
        shows up as tail latency instead of lowering offered load."""
        res = PhaseResult(label)
        cap = int(self.conf.get("loadgen_open_max_inflight"))
        sem = asyncio.Semaphore(cap)
        tasks: list[asyncio.Task] = []
        t0 = time.perf_counter()

        async def one(i: int, op: Op) -> None:
            try:
                await self._do_op(op, self._io(i), res)
            finally:
                sem.release()

        for i, op in enumerate(ops):
            due = t0 + i / qps
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            if sem.locked():
                # offered load exceeded the safety valve: record the
                # stall -- the run is no longer truly open-loop
                res.open_loop_stalls += 1
                PERF.inc("open_loop_stalls")
            await sem.acquire()
            tasks.append(asyncio.ensure_future(one(i, op)))
        await asyncio.gather(*tasks)
        res.elapsed = time.perf_counter() - t0
        return res
