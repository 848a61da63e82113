"""Cluster fault-injection driver: write -> kill -> re-peer -> verify.

The qa/tasks thrasher in miniature, built on the in-process cluster
(mon + N OSDs on loopback).  Each round writes a seeded working set to
an EC pool, kills one OSD (optionally with messenger faults armed via
common/faults.py), waits for the mon to mark it down, reads EVERY
object back under a deadline and byte-compares against what was
written, then (optionally) revives the OSD and verifies recovery
converges.  Shard mislabeling, wedged degraded reads and recovery
corruption all surface as hard failures here instead of in production.

CI smoke:  python -m ceph_tpu_torch.tools.chaos --smoke
exits non-zero on any byte mismatch, wedged read, or lost object.

Port of ``ceph_tpu/tools/chaos.py``: the cluster runs on ``device`` (CUDA
unless the caller names the CPU, ``--device`` on the command line) and
the RS pool's plugin is ``cuda``.
"""

from __future__ import annotations

import argparse
import asyncio
import random
import sys
import time

from ..common.faults import MessageFaultInjector
from ..loadgen.cluster import SimCluster
from ..msg import Message, Messenger
from ..osd.backend import pack_mutations


class ChaosCluster(SimCluster):
    """SimCluster plus a raw client messenger for low-level op drives.

    Bring-up, kill/revive tokens, wait_down/up/clean and perf
    aggregation all come from the shared ``loadgen.cluster``
    machinery; this subclass adds the bare-messenger client the chaos
    rounds use to submit ops without librados in the way.
    """

    def __init__(self, mon, osds, client,
                 faults: MessageFaultInjector | None = None) -> None:
        super().__init__(mon, osds, faults=faults)
        self.client = client
        self._op_serial = 0

    @classmethod
    async def create(cls, n_osds: int = 3, *,
                     mon_config: dict | None = None,
                     osd_config: dict | None = None,
                     faults: MessageFaultInjector | None = None,
                     device=None) -> "ChaosCluster":
        base = await SimCluster.create(
            n_osds, mon_config=mon_config, osd_config=osd_config,
            faults=faults, device=device)
        client = Messenger("client.chaos")
        await client.bind()
        return cls(base.mon, base.osds, client, faults)

    async def stop(self) -> None:
        for o in self.osds:
            await o.stop()
        await self.client.shutdown()
        await self.mon.stop()

    # -- control plane -------------------------------------------------------
    async def command(self, cmd: str, args: dict | None = None) -> dict:
        q: asyncio.Queue = asyncio.Queue()

        async def d(conn, msg):
            if msg.type == "mon_command_reply":
                await q.put(msg.data)

        self.client.add_dispatcher(d)
        try:
            await self.client.send(
                self.addr, "mon.0",
                Message("mon_command", {"cmd": cmd, "args": args or {}}))
            data = await asyncio.wait_for(q.get(), 10)
        finally:
            self.client.dispatchers.remove(d)
        if not data["ok"]:
            raise RuntimeError(data["error"])
        return data["result"]

    async def create_ec_pool(self, name: str, k: int, m: int,
                             pg_num: int, plugin: str = "cuda",
                             profile_extra: dict | None = None) -> None:
        """Create an EC pool through the standard registry path:
        ``plugin`` picks the codec family (cuda RS, lrc, pmsr) and
        ``profile_extra`` carries its extra parameters (l for lrc, d
        for pmsr) -- the same knobs an operator sets, no special-cased
        call sites."""
        profile = {"plugin": plugin, "k": str(k), "m": str(m)}
        if plugin == "cuda":
            profile["technique"] = "reed_sol_van"
        for key, val in (profile_extra or {}).items():
            profile[key] = str(val)
        pname = f"chaos-{plugin}-k{k}m{m}"
        await self.command("osd erasure-code-profile set", {
            "name": pname, "profile": profile})
        await self.command("osd pool create", {
            "name": name, "type": "erasure", "pg_num": pg_num,
            "erasure_code_profile": pname})

    # -- data plane ----------------------------------------------------------
    def _target_for(self, pool_name: str, oid: str):
        # the raw-messenger chaos client reads the mon's live map as
        # its map-subscription stand-in; a swarm port subscribes over
        # the wire via sub_osdmap instead
        # lint: disable=cross-daemon-state -- in-process map shortcut
        omap = self.mon.osdmap
        pool_id = omap.pool_names[pool_name]
        _, ps = omap.object_to_pg(pool_id, oid)
        up = omap.pg_to_up_acting_osds(pool_id, ps)
        return omap.pg_name(pool_id, ps), omap.pg_primary(up)

    async def osd_op(self, pool_name: str, oid: str, ops: list[dict],
                     timeout: float = 15.0, retries: int = 40):
        """One client op against the current primary, retrying through
        peering; the stable reqid keeps retries idempotent."""
        q: asyncio.Queue = asyncio.Queue()
        self._op_serial += 1
        tid = self._op_serial
        reqid = [f"{self.client.name}:{self.client.incarnation}", tid]

        async def d(conn, msg):
            if msg.type == "osd_op_reply" and msg.data.get("tid") == tid:
                await q.put(msg)

        self.client.add_dispatcher(d)
        try:
            for _ in range(retries):
                pgid, primary = self._target_for(pool_name, oid)
                if primary is None:
                    await asyncio.sleep(0.25)
                    continue
                addr = self.mon.osd_addr(primary)
                meta, segs = pack_mutations(ops)
                try:
                    await self.client.send(
                        tuple(addr), f"osd.{primary}",
                        Message("osd_op",
                                {"pgid": pgid, "oid": oid, "ops": meta,
                                 "reqid": reqid, "tid": tid},
                                segments=segs))
                    reply = await asyncio.wait_for(q.get(), timeout)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    await asyncio.sleep(0.25)
                    continue
                err = reply.data.get("err")
                if err in ("ENOTPRIMARY", "EAGAIN", "ENXIO no such pg"):
                    await asyncio.sleep(0.25)
                    continue
                return reply
            raise TimeoutError(f"osd_op on {oid} never succeeded")
        finally:
            self.client.dispatchers.remove(d)

async def recovery_round(c: ChaosCluster, *, rnd: random.Random,
                         pool: str, n_objects: int, obj_size: int,
                         kill_indices: list[int], log,
                         settle: float = 90.0) -> dict:
    """One kill -> degraded-write -> revive -> recover drive with the
    repair I/O counted: objects written while the victim(s) are down
    become missing shards, and the recovery that rebuilds them after
    the revive is measured via the ``ec_recovery`` counters
    (repair_bytes_read / repair_bytes_shipped -- the per-code repair
    ratio the recovery-optimal codes exist to shrink).  Returns the
    counter deltas, the recovery wall clock, and the post-recovery
    byte-verification result (every object read back and compared,
    with one of the ORIGINAL survivors killed so reads must use the
    recovered shards -- a recovery that pushed garbage or absence
    cannot pass)."""
    result = {"errors": [], "mismatched": [], "n_objects": n_objects}
    objs: dict[str, bytes] = {}
    for i in range(n_objects):
        data = rnd.getrandbits(8 * obj_size).to_bytes(obj_size,
                                                      "little")
        objs[f"rec-{i:04d}"] = data
    # base pass so the pool's PGs are primed, then the degraded pass
    # AFTER the kill is what creates the missing shards recovery must
    # rebuild
    for oid, data in objs.items():
        await c.osd_op(pool, oid, [{"op": "writefull", "data": data}])
    if not await c.wait_clean(settle):
        result["errors"].append("cluster never went clean pre-kill")
    tokens = []
    for idx in kill_indices:
        tok = await c.kill_osd(idx)
        tokens.append((idx, tok))
        if not await c.wait_down(tok["whoami"]):
            result["errors"].append(
                f"osd.{tok['whoami']} never marked down")
            return result
    log(f"  killed {[t['whoami'] for _, t in tokens]}; degraded "
        f"rewrite of {n_objects} objects")
    for oid, data in objs.items():
        await c.osd_op(pool, oid, [{"op": "writefull", "data": data}])
    rec0 = c.perf_counters("ec_recovery")
    t0 = time.perf_counter()
    for idx, tok in tokens:
        await c.revive_osd(idx, tok)
        if not await c.wait_up(tok["whoami"]):
            result["errors"].append(
                f"osd.{tok['whoami']} never came back")
            return result
    recovered = await c.wait_clean(settle)
    wall = time.perf_counter() - t0
    if not recovered:
        result["errors"].append("recovery never converged")
    rec1 = c.perf_counters("ec_recovery")
    deltas = {key: rec1.get(key, 0) - rec0.get(key, 0)
              for key in set(rec0) | set(rec1)}
    # the proof: kill one of the ORIGINAL survivors, so every read of
    # a degraded-phase object decodes THROUGH the recovered shards
    survivor = next(i for i in range(len(c.osds))
                    if i not in set(kill_indices))
    tok2 = await c.kill_osd(survivor)
    if not await c.wait_down(tok2["whoami"]):
        result["errors"].append("verify-kill never marked down")
    for oid, want in objs.items():
        try:
            reply = await asyncio.wait_for(
                c.osd_op(pool, oid,
                         [{"op": "read", "off": 0, "len": None}],
                         timeout=10, retries=8), timeout=60)
        except (TimeoutError, asyncio.TimeoutError):
            result["mismatched"].append(oid)
            continue
        r = reply.data["results"][0]
        data = reply.segments[r["seg"]] if "seg" in r else None
        if not r.get("ok") or data != want:
            result["mismatched"].append(oid)
    await c.revive_osd(survivor, tok2)
    await c.wait_up(tok2["whoami"])
    result.update({"recovery_wall_s": round(wall, 3),
                   "recovered_clean": recovered,
                   "repair": deltas})
    return result


async def run_round(c: ChaosCluster, *, rnd: random.Random,
                    pool: str, n_objects: int, min_size: int,
                    max_size: int, kill_index: int,
                    read_deadline: float, revive: bool,
                    log) -> dict:
    """One write -> kill -> re-peer -> read-back loop.  Returns a
    result dict with mismatch/wedge/error lists."""
    result = {"mismatched": [], "wedged": [], "refused": [],
              "errors": [], "n_objects": n_objects}
    objs: dict[str, bytes] = {}
    for i in range(n_objects):
        size = rnd.randrange(min_size, max_size + 1)
        data = rnd.getrandbits(8 * size).to_bytes(size, "little")
        oid = f"chaos-{i:04d}"
        objs[oid] = data
        # writefull: REPLACE semantics, so later rounds overwriting a
        # longer object from an earlier round don't leave a stale tail
        # that would read as a false mismatch
        await c.osd_op(pool, oid, [{"op": "writefull", "data": data}])
    # let laggard-healing re-pushes settle: every shard of every ack'd
    # write should be on disk before we pull an OSD out
    if not await c.wait_clean():
        result["errors"].append("cluster never went clean pre-kill")
    victim_id = c.osds[kill_index].whoami
    log(f"  wrote {n_objects} objects; killing osd.{victim_id}")
    token = await c.kill_osd(kill_index)
    if not await c.wait_down(victim_id):
        result["errors"].append(f"osd.{victim_id} never marked down")
        return result
    log(f"  osd.{victim_id} down; reading back under "
        f"{read_deadline:.0f}s deadline")
    for oid, want in objs.items():
        try:
            reply = await asyncio.wait_for(
                c.osd_op(pool, oid,
                         [{"op": "read", "off": 0, "len": None}],
                         timeout=10, retries=8),
                timeout=read_deadline)
        except (TimeoutError, asyncio.TimeoutError):
            result["wedged"].append(oid)
            continue
        if reply.data.get("err"):
            result["refused"].append(oid)
            continue
        r = reply.data["results"][0]
        data = reply.segments[r["seg"]] if "seg" in r else None
        if not r.get("ok"):
            # per-op error (e.g. EIO after bounded shard retries): the
            # read COMPLETED with a refusal -- bytes were never faked
            result["refused"].append(oid)
        elif data != want:
            result["mismatched"].append(oid)
    if revive:
        log(f"  reviving osd.{victim_id}")
        await c.revive_osd(kill_index, token)
        if not await c.wait_up(victim_id):
            result["errors"].append(f"osd.{victim_id} never came back")
    return result


async def repair_pin_drive(c: ChaosCluster, args, rnd: random.Random,
                           log) -> int:
    """--repair-pin: the per-code repair-byte assertion.  Kill one
    OSD, write degraded, revive, recover, and pin the measured
    ``ec_recovery`` read/shipped ratio against the code's repair
    math: LRC single-failure recovery must read <= (l+1)x the shipped
    bytes ((l+1)/k of what RS would read), pmsr must take the
    fragment path and read under k full chunks, and a second round
    with TWO victims pins the multi-failure fallback (global decodes
    engaged, still byte-correct)."""
    failures = 0
    res = await recovery_round(
        c, rnd=rnd, pool="chaospool", n_objects=args.objects,
        obj_size=args.max_size, kill_indices=[len(c.osds) - 1],
        log=log)
    rep = res.get("repair", {})
    log(f"  single-failure repair: {rep} "
        f"wall={res.get('recovery_wall_s')}s")
    if res["errors"] or res["mismatched"]:
        log(f"ERROR: {res['errors']} mismatched={res['mismatched']}")
        failures += 1
    read = rep.get("repair_bytes_read", 0)
    shipped = rep.get("repair_bytes_shipped", 0)
    if not shipped or not read:
        log("ERROR: recovery moved no counted bytes")
        failures += 1
    elif args.plugin == "lrc":
        bound = (args.l + 1) * shipped
        if read > bound:
            log(f"ERROR: lrc repair read {read} > (l+1)*shipped="
                f"{bound} (locality not engaged)")
            failures += 1
        if not rep.get("repair_local_repairs"):
            log("ERROR: no local repair recorded")
            failures += 1
    elif args.plugin == "pmsr":
        if not rep.get("repair_fragment_pulls"):
            log("ERROR: no fragment pull recorded")
            failures += 1
        if read >= args.k * shipped:
            log(f"ERROR: pmsr repair read {read} >= k*shipped="
                f"{args.k * shipped} (no better than RS)")
            failures += 1
    # the multi-failure fallback pin is the LAYERED code's contract
    # (local repair infeasible when a group loses two chunks); a
    # 2-kill on an MDS-width pmsr pool at m=2 would drop the pool
    # below min_size instead
    if args.plugin == "lrc" and len(c.osds) >= 2:
        res2 = await recovery_round(
            c, rnd=rnd, pool="chaospool", n_objects=args.objects,
            obj_size=args.max_size,
            kill_indices=[len(c.osds) - 1, len(c.osds) - 2],
            log=log)
        rep2 = res2.get("repair", {})
        log(f"  multi-failure repair: {rep2} "
            f"wall={res2.get('recovery_wall_s')}s")
        if res2["errors"] or res2["mismatched"]:
            log(f"ERROR: multi-failure {res2['errors']} "
                f"mismatched={res2['mismatched']}")
            failures += 1
        if args.plugin == "lrc" and not rep2.get(
                "repair_global_decodes"):
            log("ERROR: multi-failure recovery never fell back to "
                "global decode")
            failures += 1
    return failures


async def chaos_main(args) -> int:
    rnd = random.Random(args.seed)
    faults = None
    if args.msg_drop_p > 0 or args.msg_delay > 0:
        faults = MessageFaultInjector(seed=args.seed)
        if args.msg_drop_p > 0:
            faults.drop(peer="osd.", probability=args.msg_drop_p)
        if args.msg_delay > 0:
            faults.delay(args.msg_delay, peer="osd.",
                         probability=args.msg_delay_p)
    c = await ChaosCluster.create(
        args.osds,
        mon_config={"mon_osd_down_out_interval": 3600.0},
        osd_config={"osd_heartbeat_interval": 0.2,
                    "osd_heartbeat_grace": 3.0},
        faults=faults, device=args.device)
    failures = 0

    def log(msg: str) -> None:
        if not args.quiet:
            print(msg, flush=True)

    extra = {}
    if args.plugin == "lrc" and args.l:
        extra["l"] = args.l
    if args.plugin == "pmsr" and args.d:
        extra["d"] = args.d
    try:
        await c.create_ec_pool("chaospool", args.k, args.m,
                               args.pg_num, plugin=args.plugin,
                               profile_extra=extra)
        if args.repair_pin:
            failures += await repair_pin_drive(c, args, rnd, log)
            deg = c.perf_counters("ec_degraded")
            log(f"ec_degraded counters: {deg}")
            log(f"{'FAIL' if failures else 'PASS'}: "
                f"{failures} failures")
            return 1 if failures else 0
        for r in range(args.rounds):
            log(f"round {r + 1}/{args.rounds}")
            kill_index = (len(c.osds) - 1 if args.kill_last
                          else rnd.randrange(len(c.osds)))
            res = await run_round(
                c, rnd=rnd, pool="chaospool",
                n_objects=args.objects, min_size=args.min_size,
                max_size=args.max_size, kill_index=kill_index,
                read_deadline=args.read_deadline,
                revive=(r + 1 < args.rounds), log=log)
            bad = (len(res["mismatched"]) + len(res["wedged"])
                   + len(res["errors"]))
            # an EIO refusal is a failure only on a clean network: with
            # drop faults armed, a write ack'd at min_size can lose a
            # shard to the kill before the re-push lands -- the honest
            # outcome is a refused read, never fabricated bytes
            if faults is None or args.strict_reads:
                bad += len(res["refused"])
            failures += bad
            log(f"  result: {res['n_objects'] - bad}/{res['n_objects']}"
                f" clean, mismatched={res['mismatched']}, "
                f"wedged={res['wedged']}, refused={res['refused']}, "
                f"errors={res['errors']}")
        deg = c.perf_counters("ec_degraded")
        log(f"ec_degraded counters: {deg}")
        if faults is not None:
            log(f"fault_inject stats: {faults.stats}")
        if not deg.get("degraded_reads") and not args.allow_clean:
            # reading back with a dead shard holder MUST have exercised
            # reconstruction; a zero here means the drive tested nothing
            log("ERROR: no degraded reads recorded -- harness broken?")
            failures += 1
        # the client routed every op through mon.osdmap's cached table
        # and each OSD retargeted through its own; kills/re-peering
        # bump epochs, so zero bulk recomputes means the epoch-keyed
        # invalidation never fired and the drive read stale placement
        pc = c.perf_counters("placement_cache")
        mon_pc = c.mon.placement_counters()
        log(f"placement_cache counters: osds={pc} mon={mon_pc}")
        if not mon_pc.get("bulk_recomputes") or not pc.get(
                "bulk_recomputes"):
            log("ERROR: placement cache never recomputed across the "
                "kill -- invalidation broken?")
            failures += 1
    finally:
        await c.stop()
    log(f"{'FAIL' if failures else 'PASS'}: {failures} failures")
    return 1 if failures else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="EC cluster fault-injection driver")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--objects", type=int, default=24)
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--plugin", default="cuda",
                   choices=("cuda", "lrc", "pmsr"),
                   help="EC plugin for the pool (registry path)")
    p.add_argument("--l", type=int, default=0,
                   help="lrc locality parameter (chunks per local "
                        "group beside its parity)")
    p.add_argument("--d", type=int, default=0,
                   help="pmsr helper count (must be 2(k-1))")
    p.add_argument("--repair-pin", action="store_true",
                   help="kill/recover drive asserting the per-code "
                        "repair-byte ratio via the ec_recovery "
                        "counters instead of the read-back rounds")
    p.add_argument("--pg-num", type=int, default=16)
    p.add_argument("--min-size", type=int, default=8 << 10)
    p.add_argument("--max-size", type=int, default=32 << 10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--kill-last", action="store_true",
                   help="always kill the last OSD (the ROADMAP repro) "
                        "instead of a seeded random victim")
    p.add_argument("--read-deadline", type=float, default=60.0,
                   help="per-object read-back deadline; exceeding it "
                        "counts as a wedged read")
    p.add_argument("--msg-drop-p", type=float, default=0.0,
                   help="drop probability for osd<->osd messages")
    p.add_argument("--msg-delay", type=float, default=0.0,
                   help="injected delay seconds for osd<->osd messages")
    p.add_argument("--msg-delay-p", type=float, default=0.2)
    p.add_argument("--allow-clean", action="store_true",
                   help="don't fail when no degraded read was recorded")
    p.add_argument("--strict-reads", action="store_true",
                   help="count EIO-refused reads as failures even "
                        "with message faults armed")
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="CI mode: one round, kill-last, fixed seed")
    return p


def apply_smoke_overrides(args):
    """--smoke pins the CI configuration: one deterministic kill-last
    round; any byte mismatch/wedge exits non-zero."""
    if args.smoke:
        args.rounds = 1
        args.kill_last = True
        args.seed = 7
    return args


def main(argv: list[str] | None = None) -> int:
    args = apply_smoke_overrides(build_parser().parse_args(argv))
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(chaos_main(args))
    finally:
        loop.close()


if __name__ == "__main__":
    sys.exit(main())
