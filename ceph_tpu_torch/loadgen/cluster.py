"""SimCluster: mon + N OSDs in one process, scaled past toy size.

The vstart-style bring-up that ``bench.py --osd-path`` and
``tools/chaos.py`` each grew privately, factored out and scaled: OSDs
boot in small concurrent batches (serial boot of 64+ daemons pays one
mon round trip each), large clusters get slower heartbeats plus the
capped heartbeat fanout (``osd_heartbeat_max_peers``) so the ping
mesh stays O(N), and the kill/revive/wait helpers the chaos driver
pioneered live here for any harness to reuse.

``ChaosCluster`` (tools/chaos.py) subclasses this and adds its raw
messenger client; the loadgen swarm talks librados instead.

Port of ``ceph_tpu/loadgen/cluster.py``: every daemon of a cluster runs on
the cluster's ``device`` (CUDA unless the caller names the CPU), a
revived OSD on its peers' device.  And the cluster keeps its settled heap
out of the cyclic collector (``settle_heap``): one interpreter holds what
64 daemons and their clients hold, and a full collection that walks it all
stalls every heartbeat of the loop (0.4-0.6 s a collection at 64 OSDs on
the host of an H100 machine).
"""

from __future__ import annotations

import asyncio
import gc
import time

from ..common.faults import MessageFaultInjector
from ..mon import Monitor
from ..osd import OSD

# bring-up concurrency: mon paxos serializes the boots anyway; small
# batches overlap messenger setup without racing id assignment hard
BOOT_BATCH = 8


class SimCluster:
    """Mon + N OSDs with kill/revive helpers and perf aggregation."""

    def __init__(self, mon: Monitor, osds: list[OSD],
                 faults: MessageFaultInjector | None = None) -> None:
        self.mon = mon
        self.osds = osds
        self.faults = faults

    @classmethod
    async def create(cls, n_osds: int = 3, *,
                     mon_config: dict | None = None,
                     osd_config: dict | None = None,
                     faults: MessageFaultInjector | None = None,
                     log=None, device=None) -> "SimCluster":
        cls._tune_placement_for_scale(n_osds)
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1,
                                      **(mon_config or {})},
                      device=device)
        addr = await mon.start()
        cfg = dict(cls.scaled_osd_config(n_osds))
        cfg.update(osd_config or {})
        osds: list[OSD] = []

        async def boot(i: int) -> OSD:
            osd = OSD(host=f"host{i}", config=cfg,
                      fault_injector=faults, device=mon.device)
            await osd.start(addr)
            return osd

        for base in range(0, n_osds, BOOT_BATCH):
            batch = range(base, min(base + BOOT_BATCH, n_osds))
            osds.extend(await asyncio.gather(*(boot(i) for i in batch)))
            if log is not None and n_osds > BOOT_BATCH:
                log(f"  booted {len(osds)}/{n_osds} osds")
        cluster = cls(mon, osds, faults=faults)
        cluster.settle_heap()
        return cluster

    @staticmethod
    def settle_heap() -> None:
        """Collect once, then move every live object into the collector's
        permanent generation (``gc.freeze``): later collections walk only
        what was made since.  At boot and after a harness's load stage;
        ``stop`` gives the objects back to the collector."""
        gc.collect()
        gc.freeze()

    @staticmethod
    def _tune_placement_for_scale(n_osds: int) -> None:
        """Big clusters must ride the fused placement path.

        The scalar per-PG CRUSH sweep costs ~0.5s per table rebuild on
        a 64-OSD map; during peering/recovery churn every daemon
        rebuilds per epoch, which saturates the event loop, delays
        heartbeats, triggers FALSE failure reports and feeds back into
        more epochs (observed as a 48-OSD bring-up wedged for minutes).
        Lowering the fused first-compile threshold (the same module
        knob ``bench.py --placement --smoke`` pins) makes the first
        post-pool-create rebuild pay one jit compile and every later
        epoch a ~ms vectorized launch.  An explicit operator override
        via CEPH_TPU_PLACEMENT_FUSED_MIN is respected.
        """
        import os
        if n_osds < 24 or "CEPH_TPU_PLACEMENT_FUSED_MIN" in os.environ:
            return
        from ..mon import pg_mapping
        pg_mapping.FUSED_MIN_LANES = min(pg_mapping.FUSED_MIN_LANES,
                                         192)

    @staticmethod
    def scaled_osd_config(n_osds: int) -> dict:
        """Defaults that keep a big cluster's control plane cheap:
        the heartbeat interval backs off with size (the capped fanout
        bounds per-OSD cost, this bounds aggregate message rate) while
        the grace scales with it so detection stays reliable."""
        if n_osds <= 16:
            return {"osd_heartbeat_interval": 0.5,
                    "osd_heartbeat_grace": 3.0}
        interval = 1.0 if n_osds <= 128 else 2.0
        return {"osd_heartbeat_interval": interval,
                "osd_heartbeat_grace": 6 * interval}

    @property
    def addr(self):
        return self.mon.addr

    async def stop(self) -> None:
        for o in self.osds:
            await o.stop()
        await self.mon.stop()
        gc.unfreeze()

    # -- fault actions (the chaos machinery, shared) -------------------------
    async def kill_osd(self, index: int) -> dict:
        """Stop an OSD, keeping what a revive needs."""
        osd = self.osds[index]
        token = osd.revive_token()
        await osd.stop()
        return token

    async def revive_osd(self, index: int, token: dict) -> None:
        osd = OSD(uuid=token["uuid"], whoami=token["whoami"],
                  store=token["store"], host=token["host"],
                  config=token["config"], fault_injector=self.faults,
                  device=token["device"])
        await osd.start(self.mon.addr)
        self.osds[index] = osd

    async def wait_down(self, osd_id: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.mon.osd_is_up(osd_id):
                return True
            await asyncio.sleep(0.2)
        return False

    async def wait_up(self, osd_id: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.mon.osd_is_up(osd_id):
                return True
            await asyncio.sleep(0.2)
        return False

    async def wait_clean(self, timeout: float = 30.0) -> bool:
        """Best-effort wait until no primary has pending recovery."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not any(osd.has_pending_recovery()
                       for osd in self.osds):
                return True
            await asyncio.sleep(0.2)
        return False

    # -- observability -------------------------------------------------------
    def perf_counters(self, which: str) -> dict:
        """One counter set summed across live OSDs; numeric values
        only (histogram/avg dict entries are skipped — use
        ``perf_dump`` for the full structures)."""
        out: dict[str, int | float] = {}
        for osd in self.osds:
            # a killed-but-not-yet-revived OSD still sits in the list;
            # counting its frozen lifetime counters makes phase deltas
            # spanning the revive (which swaps in a fresh instance, at
            # zero) go negative
            if osd.is_stopped():
                continue
            pc = osd.perf.get(which)
            if pc is None:
                continue
            for key, val in pc.dump().items():
                if isinstance(val, (int, float)):
                    out[key] = out.get(key, 0) + val
        return out

    def scheduler_counters(self) -> dict:
        """The dmClock sets rolled up for QoS reporting: dispatch and
        enqueue totals summed, queue-depth gauges reported as the MAX
        across OSDs (a sum of instantaneous depths means nothing)."""
        out: dict[str, float] = {}
        for osd in self.osds:
            if osd.is_stopped():
                continue
            pc = osd.perf.get("scheduler")
            if pc is None:
                continue
            for key, val in pc.dump().items():
                if not isinstance(val, (int, float)):
                    continue
                if key.startswith("depth"):
                    out[key] = max(out.get(key, 0), val)
                else:
                    out[key] = out.get(key, 0) + val
        return out

    def pg_states(self) -> dict[str, int]:
        states: dict[str, int] = {}
        for osd in self.osds:
            if osd.is_stopped():
                continue
            for state, n in osd.primary_pg_states().items():
                states[state] = states.get(state, 0) + n
        return states
