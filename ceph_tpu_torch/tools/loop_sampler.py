"""Where an event loop's thread spends its time, and how long it stalls.

The in-process cluster runs every daemon and client on one asyncio loop, so
whatever holds that thread delays every heartbeat and every op.  Probes:

* ``LoopSampler``: a thread reads the loop thread's stack every
  ``interval`` seconds and counts, for each sample, the innermost frame and
  every function of this package on the stack; a sample whose innermost
  frame is the selector's wait is idle.  The walk reads code objects only
  (no source lines), so a sample holds the interpreter for microseconds.
* ``LoopLag``: a task on the loop sleeps ``interval`` seconds at a time and
  records by how much each wake-up came late: the loop's stalls, in a
  ``LatencyHistogram`` by stage (max, p99);
* ``GCClock``: the cyclic collector's pauses by stage.

    python -m ceph_tpu_torch.tools.loop_sampler --objects 1000 --ops 1000 \\
        --recovery-ops 300 [--device cpu] [--heartbeat 1.0 6.0]

runs ``run_workload`` at ``bench.py::_cluster_spec(smoke=False)``'s shape (64
OSDs, an EC 2+1 pool at pg_num 256, objects lognormal around 16 KiB, 32
closed-loop clients, one OSD killed under traffic) with the given depth and
``SimCluster``'s own heartbeats (or ``--heartbeat``'s interval and grace),
and prints one JSON object: each stage's ops, ops/s, failed and wedged ops,
the cluster log's mark-downs, K5's launches, the tables built and the map
epochs by stage, the loop's stalls and the collector's pauses by stage, and
the samples, in all and by stage.  Exits 1 when an op failed or wedged, or
``--deadline`` cut the run (what was sampled is printed all the same).
``--no-settle-heap`` leaves the heap in the collector, to measure what
``SimCluster.settle_heap`` saves; ``--cprofile N`` prints the run's N
costliest functions to stderr.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import gc
import json
import os
import sys
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class LoopSampler:
    """Samples ``thread_id``'s stack (default: the calling thread's) every
    ``interval`` seconds between ``start`` and ``stop``; ``roots`` are the
    directories whose functions are counted inclusively."""

    def __init__(self, interval: float = 0.01, thread_id: int | None = None,
                 roots: tuple[str, ...] = (_PKG,)) -> None:
        self.interval = interval
        self.thread_id = thread_id or threading.get_ident()
        self.roots = tuple(os.path.dirname(r) + os.sep for r in roots)
        self.samples = 0
        self.idle = 0
        self.leaf: collections.Counter = collections.Counter()
        self.inclusive: collections.Counter = collections.Counter()
        # stage -> [samples, idle, inclusive counts] (``mark``)
        self.stages: dict[str, list] = {}
        self._stage = self._open("start")
        self._names: dict = {}           # code object -> counted name
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _open(self, stage: str) -> list:
        return self.stages.setdefault(stage, [0, 0, collections.Counter()])

    def mark(self, stage: str) -> None:
        """Count the samples from here on under ``stage``."""
        self._stage = self._open(stage)

    def _name(self, code) -> str | None:
        name = self._names.get(code, False)
        if name is False:
            name = None
            path = code.co_filename
            if path != __file__:         # the driver below, on every sample
                for root in self.roots:
                    if path.startswith(root):
                        name = f"{path[len(root):]}:{code.co_name}"
                        break
            self._names[code] = name
        return name

    def _sample(self) -> None:
        frame = sys._current_frames().get(self.thread_id)
        if frame is None:
            return
        stage = self._stage
        self.samples += 1
        stage[0] += 1
        inner = frame.f_code
        if os.path.basename(inner.co_filename) == "selectors.py":
            self.idle += 1
            stage[1] += 1
            return
        self.leaf[f"{os.path.basename(inner.co_filename)}:"
                  f"{inner.co_name}"] += 1
        names = set()
        while frame is not None:
            names.add(self._name(frame.f_code))
            frame = frame.f_back
        names.discard(None)
        for name in names:
            self.inclusive[name] += 1
            stage[2][name] += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def start(self) -> "LoopSampler":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def summary(self, top: int = 30) -> dict:
        """Counts of samples: all, idle, and the ``top`` innermost frames
        and package functions (a function counts once a sample); the same
        by stage, the ``top // 2`` functions each."""
        return {"samples": self.samples, "idle": self.idle,
                "leaf": self.leaf.most_common(top),
                "inclusive": self.inclusive.most_common(top),
                "stages": {name: {"samples": n, "idle": idle,
                                  "inclusive": c.most_common(top // 2)}
                           for name, (n, idle, c) in self.stages.items()}}


class LoopLag:
    """The running loop's stalls: a task sleeps ``interval`` seconds at a
    time and records how late each wake-up came (seconds past the sleep),
    by stage (``mark``).  ``start`` on the loop, ``stop`` before it
    closes."""

    def __init__(self, interval: float = 0.01) -> None:
        from ..loadgen.histogram import LatencyHistogram
        self._hist = LatencyHistogram
        self.interval = interval
        self.stages: dict[str, LatencyHistogram] = {}
        self._stage = self._open("start")
        self._task: asyncio.Task | None = None

    def _open(self, stage: str):
        return self.stages.setdefault(stage, self._hist())

    def mark(self, stage: str) -> None:
        """Record the stalls from here on under ``stage``."""
        self._stage = self._open(stage)

    async def _run(self) -> None:
        clock = time.perf_counter
        while True:
            t = clock()
            await asyncio.sleep(self.interval)
            self._stage.record(clock() - t - self.interval)

    def start(self) -> "LoopLag":
        self._task = asyncio.ensure_future(self._run())
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def summary(self) -> dict:
        """Per stage: wake-ups, the longest stall and the p99, seconds."""
        return {name: {"wakeups": h.n, "max_s": round(h.max, 6),
                       "p99_s": round(h.percentile(99.0), 6) if h.n else 0.0}
                for name, h in self.stages.items()}


class GCClock:
    """The cyclic collector's pauses, by stage (``mark``): a callback of
    ``gc.callbacks`` times each collection on the thread that runs it (the
    loop's, which allocates).  ``stop`` removes it."""

    def __init__(self) -> None:
        self.stages: dict[str, dict] = {}
        self._stage = self._open("start")
        self._t0: float | None = None
        gc.callbacks.append(self._cb)

    def _open(self, stage: str) -> dict:
        return self.stages.setdefault(
            stage, {"collections": [0, 0, 0], "s": 0.0, "max_s": 0.0})

    def mark(self, stage: str) -> None:
        self._stage = self._open(stage)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            st = self._stage
            st["collections"][info["generation"]] += 1
            st["s"] += dt
            st["max_s"] = max(st["max_s"], dt)
            self._t0 = None

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {name: {"collections": st["collections"],
                       "s": round(st["s"], 6), "max_s": round(st["max_s"], 6)}
                for name, st in self.stages.items()}


class StageCounts:
    """K5's launches, the placement tables built, the monitor's map epoch,
    the clients' resends by cause and the duplicate reqids the PGs saw at
    the end of each stage (``mark(stage, cluster)``), as differences from
    the previous mark."""

    def __init__(self) -> None:
        self.stages: dict[str, dict] = {}
        self._last = self._now(None)

    @staticmethod
    def _now(cluster) -> dict:
        from ..client.objecter import RESEND_CAUSES, RESENDS
        from ..crush.vectorized import LAUNCHES
        from ..mon.pg_mapping import BUILDS
        from ..osd.pg import DUP_REQIDS
        return {"k5": LAUNCHES["crush_map_rule"], "tables": BUILDS["tables"],
                "epochs": cluster.mon.osdmap.epoch if cluster else 0,
                **{f"resend_{k}": RESENDS[k] for k in RESEND_CAUSES},
                **{f"dup_{k}": DUP_REQIDS[k]
                   for k in ("completed", "inflight")}}

    def mark(self, stage: str, cluster) -> None:
        now = self._now(cluster)
        self.stages[stage] = {k: now[k] - self._last[k] for k in now}
        self._last = now


def mark_downs(cluster) -> list[str]:
    """The cluster log's mark-down entries, oldest first."""
    return [e["message"] for e in cluster.mon.services.cluster_log
            if "marked down" in e.get("message", "")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.tools.loop_sampler",
        description="run_workload at bench.py's cluster shape, sampling "
                    "where the event loop's thread spends its time")
    p.add_argument("--objects", type=int, default=1000)
    p.add_argument("--ops", type=int, default=1000)
    p.add_argument("--recovery-ops", type=int, default=300)
    p.add_argument("--osds", type=int, default=64)
    p.add_argument("--pg-num", type=int, default=256)
    p.add_argument("--heartbeat", type=float, nargs=2, default=None,
                   metavar=("INTERVAL", "GRACE"),
                   help="the OSDs' heartbeat interval and grace (default: "
                        "SimCluster's, scaled by the cluster's size)")
    p.add_argument("--deadline", type=float, default=None,
                   help="seconds after which the run is cancelled and "
                        "what was sampled is printed")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu")
    p.add_argument("--no-settle-heap", action="store_true",
                   help="leave the heap in the cyclic collector "
                        "(SimCluster.settle_heap does nothing): the "
                        "collector's cost, measured against a default run")
    p.add_argument("--cprofile", type=int, default=0, metavar="N",
                   help="profile the run with cProfile and print its N "
                        "costliest functions by cumulative and by own "
                        "time to stderr (cProfile slows the loop)")
    p.add_argument("--quiet", action="store_true")
    return p


def run(args, workload=None) -> dict:
    """``args`` as ``build_parser`` parses them; ``workload`` runs in place
    of ``run_workload`` (same keywords: a caller's adapter)."""
    from ..loadgen import WorkloadSpec, run_workload
    workload = workload or run_workload
    extra = {}
    if args.heartbeat:
        extra["osd_config"] = {"osd_heartbeat_interval": args.heartbeat[0],
                               "osd_heartbeat_grace": args.heartbeat[1]}
    spec = WorkloadSpec(
        n_osds=args.osds, pg_num=args.pg_num, n_objects=args.objects,
        obj_size=16 << 10, n_ops=args.ops, n_clients=32,
        recovery_ops=args.recovery_ops, kill_osds=1, size_dist="lognormal",
        seed=args.seed, extra=extra).validate()
    t0 = time.perf_counter()
    seen: dict = {}

    def log(msg: str) -> None:
        if not args.quiet:
            print(f"[{time.perf_counter() - t0:7.1f}] {msg}", file=sys.stderr,
                  flush=True)

    counts = StageCounts()
    lag = LoopLag()
    collector = GCClock()

    async def on_stage(stage, cluster, report):
        counts.mark(stage, cluster)
        sampler.mark(f"after {stage}")
        lag.mark(f"after {stage}")
        collector.mark(f"after {stage}")
        if stage == "report":
            seen["mark_downs"] = mark_downs(cluster)

    async def drive():
        lag.start()
        try:
            return await asyncio.wait_for(workload(
                spec, log=log, device=args.device, on_stage=on_stage),
                args.deadline)
        finally:
            lag.stop()

    from ..loadgen.cluster import SimCluster
    settle = SimCluster.__dict__["settle_heap"]      # the staticmethod
    if args.no_settle_heap:
        SimCluster.settle_heap = staticmethod(lambda: None)
    profiler = None
    if args.cprofile:
        import cProfile
        profiler = cProfile.Profile()
    sampler = LoopSampler().start()
    loop = asyncio.new_event_loop()
    report: dict = {"phases": {}}
    error = None
    try:
        if profiler is not None:
            profiler.enable()
        report = loop.run_until_complete(drive())
    except asyncio.TimeoutError:
        error = f"cancelled at the {args.deadline} s deadline"
    finally:
        if profiler is not None:
            profiler.disable()
        loop.close()
        sampler.stop()
        collector.stop()
        SimCluster.settle_heap = settle
    if profiler is not None:
        import pstats
        stats = pstats.Stats(profiler, stream=sys.stderr)
        stats.sort_stats("cumulative").print_stats(args.cprofile)
        stats.sort_stats("tottime").print_stats(args.cprofile)
    return {
        "spec": spec.to_dict(),
        "error": error,
        "stages": {name: {"ops": ph["ops"],
                          "ops_per_s": ph["timing"]["ops_per_s"],
                          "failed": ph["failed_ops"],
                          "wedged": ph["wedged_ops"]}
                   for name, ph in report["phases"].items()},
        "interference": report.get("interference"),
        "mark_downs": seen.get("mark_downs", []),
        "counts_by_stage": counts.stages,
        "stalls_by_stage": lag.summary(),
        "gc_by_stage": collector.summary(),
        "seconds": round(time.perf_counter() - t0, 3),
        "loop": sampler.summary(),
    }


def main(argv=None) -> int:
    res = run(build_parser().parse_args(argv))
    print(json.dumps(res))
    bad = res["error"] or any(s["failed"] or s["wedged"]
                              for s in res["stages"].values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
