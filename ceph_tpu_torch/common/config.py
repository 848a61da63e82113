"""Typed configuration registry with change observers.

The src/common/options + ConfigProxy analog: options are declared in a
typed schema (name/type/level/default/min/max/enum/desc — the shape of
src/common/options/*.yaml.in), values layer defaults < file < env <
runtime overrides, and observers get notified on runtime changes
(md_config_obs_t, src/common/config_proxy.h:15-180).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable

OPT_INT = "int"
OPT_FLOAT = "float"
OPT_STR = "str"
OPT_BOOL = "bool"

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

_CASTERS = {
    OPT_INT: int,
    OPT_FLOAT: float,
    OPT_STR: str,
    OPT_BOOL: lambda v: (v if isinstance(v, bool)
                         else str(v).lower() in ("1", "true", "yes", "on")),
}


@dataclass
class Option:
    name: str
    type: str
    default: Any
    desc: str = ""
    level: str = LEVEL_ADVANCED
    min: float | None = None
    max: float | None = None
    enum_values: list[str] = field(default_factory=list)

    def cast(self, value: Any) -> Any:
        try:
            v = _CASTERS[self.type](value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{self.name}={value!r} is not a valid {self.type}")
        if self.min is not None and v < self.min:
            raise ValueError(f"{self.name}={v} below min {self.min}")
        if self.max is not None and v > self.max:
            raise ValueError(f"{self.name}={v} above max {self.max}")
        if self.enum_values and v not in self.enum_values:
            raise ValueError(
                f"{self.name}={v!r} not in {self.enum_values}")
        return v


# the schema the daemons share (subset of the reference's option set,
# same names where the concept carries over)
DEFAULT_SCHEMA: list[Option] = [
    Option("osd_heartbeat_interval", OPT_FLOAT, 0.5,
           "seconds between peer pings", min=0.01),
    Option("osd_heartbeat_grace", OPT_FLOAT, 4.0,
           "seconds of silence before reporting a peer down", min=0.1),
    Option("osd_pool_default_size", OPT_INT, 3,
           "replica count for new pools", min=1),
    Option("osd_pool_default_min_size", OPT_INT, 2,
           "min replicas to accept writes", min=1),
    Option("osd_pool_default_pg_num", OPT_INT, 32,
           "pg count for new pools", min=1),
    Option("osd_recovery_max_active", OPT_INT, 3,
           "max concurrent recovery ops per OSD", min=1),
    Option("osd_client_op_priority", OPT_INT, 63, "client op priority"),
    Option("osd_scrub_interval", OPT_FLOAT, 60.0,
           "seconds between periodic scrubs", min=0.0),
    Option("mon_osd_min_down_reporters", OPT_INT, 2,
           "distinct reporters before marking an osd down", min=1),
    Option("mon_osd_down_out_interval", OPT_FLOAT, 600.0,
           "seconds down before auto-out", min=0.0),
    Option("mon_lease", OPT_FLOAT, 5.0, "paxos leader lease seconds"),
    Option("osd_erasure_code_plugins", OPT_STR, "cuda isa lrc pmsr",
           "plugins preloaded at daemon start"),
    Option("osd_pool_default_erasure_code_profile", OPT_STR,
           "plugin=cuda k=2 m=1 technique=reed_sol_van",
           "default EC profile"),
    Option("osd_peering_retry_base", OPT_FLOAT, 0.5,
           "initial peering retry delay (doubles per attempt)",
           min=0.01),
    Option("osd_peering_retry_max", OPT_FLOAT, 8.0,
           "peering retry backoff ceiling in seconds", min=0.01),
    Option("osd_peering_retry_jitter", OPT_FLOAT, 0.25,
           "fraction of the delay randomized to de-synchronize "
           "retrying primaries", min=0.0, max=1.0),
    Option("osd_wait_acting_change_timeout", OPT_FLOAT, 10.0,
           "seconds to hold peering for a requested pg_temp override "
           "before serving the interval ourselves", min=0.1),
    Option("osd_ec_read_timeout", OPT_FLOAT, 5.0,
           "per-attempt deadline for an EC shard fetch fanout",
           min=0.1),
    Option("osd_ec_read_retries", OPT_INT, 3,
           "extra rounds a degraded shard gather may retry failed "
           "sources before erroring the read", min=0),
    Option("osd_ec_read_backoff", OPT_FLOAT, 0.25,
           "base backoff between shard-gather retry rounds", min=0.0),
    Option("osd_ec_hedge_enabled", OPT_BOOL, True,
           "straggler-tolerant EC gathers: request extra shards after "
           "the adaptive per-peer latency quantile and decode from "
           "the first sufficient set (osd/hedged_gather.py)"),
    Option("osd_ec_hedge_quantile", OPT_FLOAT, 0.9,
           "latency quantile of the candidate-peer cohort the hedge "
           "timer arms on", min=0.5, max=0.999),
    Option("osd_ec_hedge_delay_min", OPT_FLOAT, 0.002,
           "hedge delay floor in seconds (never hedge faster than "
           "this, however fast the cohort looks)", min=0.0),
    Option("osd_ec_hedge_delay_max", OPT_FLOAT, 1.0,
           "hedge delay ceiling in seconds; also the conservative "
           "delay while the peer EWMAs are cold", min=0.001),
    Option("osd_ec_hedge_max_extra", OPT_INT, 2,
           "max extra shards (h) one hedge fire may request", min=0),
    Option("osd_ec_hedge_min_samples", OPT_INT, 8,
           "sub-read samples before a peer's EWMA quantile estimate "
           "is trusted by the hedge timer", min=1),
    Option("osd_ec_hedge_ewma_alpha", OPT_FLOAT, 0.2,
           "EWMA smoothing factor for per-peer sub-read latency",
           min=0.001, max=1.0),
    Option("osd_max_backfills", OPT_INT, 2,
           "concurrent backfill reservations per OSD (local+remote)",
           min=1),
    Option("osd_max_scrubs", OPT_INT, 1,
           "concurrent scrub slots per OSD", min=1),
    Option("osd_client_message_size_cap", OPT_INT, 500 << 20,
           "in-flight client payload bytes before backpressure",
           min=1),
    Option("osd_op_complaint_time", OPT_FLOAT, 30.0,
           "seconds in flight before an op is complained about",
           min=0.1),
    Option("osd_scrub_auto_repair", OPT_BOOL, True,
           "repair scrub-detected inconsistencies automatically"),
    Option("osd_ec_batch_enabled", OPT_BOOL, True,
           "coalesce EC codec work across PGs into shared launches"),
    Option("osd_ec_batch_max", OPT_INT, 64,
           "max stripes per coalesced codec launch", min=1),
    Option("osd_ec_batch_timeout", OPT_FLOAT, 0.002,
           "seconds a partial codec batch waits before flushing",
           min=0.0),
    Option("osd_ec_batch_eager_flush", OPT_BOOL, True,
           "flush the codec batch when the event loop goes idle"),
    Option("osd_ec_mesh_enabled", OPT_BOOL, True,
           "launch coalesced EC batches through the sharded device "
           "mesh (stripe axis partitioned over all visible chips; "
           "single-device is a 1-device mesh on the same code path)"),
    Option("osd_ec_mesh_devices", OPT_INT, 0,
           "devices in the codec mesh (0 = all visible)", min=0),
    Option("osd_ec_mesh_donate", OPT_BOOL, True,
           "donate stripe buffers to mesh launches (consume the "
           "device copy in place instead of defensive-copying it)"),
    Option("osd_datapath_cache_enabled", OPT_BOOL, True,
           "keep hot shard buffers device-resident across encode -> "
           "commit -> read-verify -> scrub -> decode (the (object, "
           "shard) cache in os/device_cache.py)"),
    Option("osd_datapath_cache_bytes", OPT_INT, 64 << 20,
           "byte budget of the device-resident shard cache (LRU past "
           "it)", min=0),
    Option("osd_datapath_cache_entry_max", OPT_INT, 8 << 20,
           "largest single shard buffer the cache will hold (bigger "
           "shards always read through the store)", min=0),
    Option("osd_ec_repair_fragments_enabled", OPT_BOOL, True,
           "regenerating-code repair fragments: rebuild a lost shard "
           "from d beta-sized computed sub-chunks (one per helper) "
           "instead of k full chunks when the pool's codec supports "
           "it (the pmsr plugin); any fragment failure falls back to "
           "the full shard gather"),
    Option("osd_ec_rmw_delta_enabled", OPT_BOOL, True,
           "partial-stripe writes delta-update parity in place "
           "(parity' = parity XOR encode(delta)) instead of "
           "re-encoding whole stripes; unchanged data shards ship "
           "version-stamp-only sub-writes"),
    Option("osd_pipeline_enabled", OPT_BOOL, True,
           "pipeline the OSD write hot path: double-buffered codec "
           "launches, commits/flushes awaited outside the PG lock "
           "(per-(PG, object) ordering preserved), per-peer sub-op "
           "coalescing.  The kill switch: false restores the serial "
           "gather -> encode -> commit -> fan-out chain end to end"),
    Option("osd_pipeline_staging_depth", OPT_INT, 4,
           "marshaled codec batches parked between staging and "
           "launch; a flush finding the queue full launches inline "
           "(a counted stall), so this bounds parked host memory",
           min=1),
    Option("osd_pipeline_flush_window", OPT_FLOAT, 0.002,
           "seconds the per-peer sub-op coalescer waits for "
           "co-submitters before shipping one framed flush per peer "
           "(drains early when the event loop goes idle)", min=0.0),
    Option("osd_heartbeat_max_peers", OPT_INT, 10,
           "heartbeat fanout cap: PG peers + id-ring neighbors "
           "instead of the O(N^2) full mesh (0 = uncapped)", min=0),
    Option("mon_up_thru_batch_window", OPT_FLOAT, 0.05,
           "seconds the leader coalesces up_thru bumps before "
           "committing them as one epoch (per-PG epoch storms on "
           "pool create otherwise)", min=0.0),
    Option("auth_service_ticket_ttl", OPT_FLOAT, 3600.0,
           "cephx service ticket lifetime seconds", min=1.0),
    Option("auth_ticket_ttl", OPT_FLOAT, 600.0,
           "cephx auth ticket lifetime seconds", min=1.0),
    Option("prometheus_port", OPT_INT, 0,
           "mgr prometheus exporter port (0 = ephemeral)", min=0),
    Option("dashboard_enabled", OPT_BOOL, True,
           "serve the mgr dashboard"),
    Option("dashboard_port", OPT_INT, 0,
           "mgr dashboard port (0 = ephemeral)", min=0),
    Option("telemetry_on", OPT_BOOL, False,
           "enable the mgr telemetry module"),
    # -- loadgen (the cluster traffic harness, ceph_tpu/loadgen) ----------
    Option("loadgen_rados_handles", OPT_INT, 8,
           "Rados connections the client swarm multiplexes over",
           min=1),
    Option("loadgen_op_timeout", OPT_FLOAT, 30.0,
           "per-op client deadline; exceeding it is a wedged op",
           min=0.1),
    Option("loadgen_open_max_inflight", OPT_INT, 1024,
           "open-loop safety valve: max ops in flight before the "
           "dispatcher stalls (stalls are reported, not hidden)",
           min=1),
    Option("loadgen_preload_concurrency", OPT_INT, 64,
           "concurrent writes while preloading the working set",
           min=1),
    Option("loadgen_kill_osds", OPT_INT, 1,
           "OSDs killed by the recovery-interference phase", min=0),
    Option("loadgen_recovery_settle", OPT_FLOAT, 15.0,
           "seconds allowed for the mon to mark the victim down",
           min=0.1),
    Option("loadgen_hist_growth", OPT_FLOAT, 2 ** 0.125,
           "latency histogram bucket growth factor (bounds the "
           "relative error of reported percentiles)", min=1.0001),
    Option("loadgen_hist_min_s", OPT_FLOAT, 1e-5,
           "latency histogram first bucket upper bound (seconds)",
           min=1e-9),
    Option("debug_osd", OPT_INT, 1, "osd log verbosity", min=0, max=20,
           level=LEVEL_DEV),
    Option("debug_mon", OPT_INT, 1, "mon log verbosity", min=0, max=20,
           level=LEVEL_DEV),
    Option("debug_ms", OPT_INT, 0, "messenger log verbosity", min=0,
           max=20, level=LEVEL_DEV),
    Option("log_max_recent", OPT_INT, 1000,
           "ring-buffered log entries kept for crash dump", min=0),
]


class ConfigProxy:
    """Layered typed config: defaults < file < env < runtime set()."""

    ENV_PREFIX = "CEPH_TPU_"

    def __init__(self, schema: list[Option] | None = None,
                 conf_file: str | None = None,
                 values: dict | None = None,
                 read_env: bool = True) -> None:
        self.schema: dict[str, Option] = {
            o.name: o for o in (schema or DEFAULT_SCHEMA)}
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        if conf_file and os.path.exists(conf_file):
            self._load_file(conf_file)
        if read_env:
            self._load_env()
        for k, v in (values or {}).items():
            self.set(k, v, notify=False)

    def _load_file(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        for k, v in data.items():
            if k in self.schema:
                self._values[k] = self.schema[k].cast(v)

    def _load_env(self) -> None:
        for name, opt in self.schema.items():
            env = os.environ.get(self.ENV_PREFIX + name.upper())
            if env is not None:
                self._values[name] = opt.cast(env)

    # -- access -------------------------------------------------------------
    def get(self, name: str) -> Any:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        return self._values.get(name, opt.default)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, notify: bool = True) -> None:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        v = opt.cast(value)
        self._values[name] = v
        if notify:
            for cb in self._observers.get(name, []):
                cb(name, v)

    def add_observer(self, name: str,
                     cb: Callable[[str, Any], None]) -> None:
        if name not in self.schema:
            raise KeyError(f"unknown option {name}")
        self._observers.setdefault(name, []).append(cb)

    # -- introspection (`ceph config help/show` analog) ---------------------
    def show(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(self.schema)}

    def describe(self, name: str) -> dict:
        o = self.schema[name]
        return {"name": o.name, "type": o.type, "level": o.level,
                "default": o.default, "desc": o.desc, "min": o.min,
                "max": o.max, "enum_values": o.enum_values,
                "current": self.get(name)}
