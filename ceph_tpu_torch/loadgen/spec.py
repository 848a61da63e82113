"""WorkloadSpec: a production-shaped op stream, deterministically.

The spec is pure data + pure functions: the same (spec, seed) always
yields the same working set (object names and sizes) and the same op
schedule (kind/object/offset sequence), so a loadgen run is
reproducible op-for-op and a report's deterministic half is
byte-identical across runs.  Nothing here touches the cluster.

Shapes covered (the mixes "Understanding System Characteristics of
Online Erasure Coding..." showed surface online-EC bottlenecks only
under concurrency):

* read/write/RMW mix — RMW is a partial overwrite at a non-zero
  offset, the EC read-modify-write amplification path;
* object sizes fixed / uniform / lognormal, pinned PER OBJECT so
  offsets stay valid no matter how ops interleave;
* key popularity uniform or Zipf (hot keys contend on their PGs);
* replicated or EC pools; open- or closed-loop issue with a target
  QPS (0 = unthrottled closed loop).
"""

from __future__ import annotations

import hashlib
import itertools
import math
import random
from dataclasses import asdict, dataclass, field
from typing import Iterator, NamedTuple

KINDS = ("read", "write", "rmw")


class Op(NamedTuple):
    kind: str       # read | write | rmw
    oid: str
    size: int       # bytes written (write/rmw) or 0 (read = full)
    off: int        # offset (rmw only; write is writefull at 0)


@dataclass
class WorkloadSpec:
    # -- cluster shape ------------------------------------------------------
    n_osds: int = 8
    pg_num: int = 64
    pool: str = "loadpool"
    pool_type: str = "erasure"          # erasure | replicated
    ec_k: int = 2
    ec_m: int = 1
    replica_size: int = 3

    # -- working set --------------------------------------------------------
    n_objects: int = 1000
    size_dist: str = "fixed"            # fixed | uniform | lognormal
    obj_size: int = 16 << 10            # fixed size / distribution mean
    size_min: int = 4 << 10
    size_max: int = 64 << 10

    # -- op stream ----------------------------------------------------------
    n_ops: int = 2000                   # steady-phase ops
    read_frac: float = 0.5
    write_frac: float = 0.35
    rmw_frac: float = 0.15
    rmw_bytes: int = 2048               # partial-overwrite span
    popularity: str = "zipf"            # zipf | uniform
    zipf_s: float = 1.1

    # -- issue discipline ---------------------------------------------------
    n_clients: int = 16
    mode: str = "closed"                # closed | open
    target_qps: float = 0.0             # 0 = unthrottled (closed only)

    # -- recovery interference ----------------------------------------------
    recovery_ops: int = 0               # 0 = skip the phase
    kill_osds: int = 1

    seed: int = 1
    name: str = "default"
    extra: dict = field(default_factory=dict)

    # -- validation ---------------------------------------------------------
    def validate(self) -> "WorkloadSpec":
        if self.pool_type not in ("erasure", "replicated"):
            raise ValueError(f"pool_type {self.pool_type!r}")
        if self.size_dist not in ("fixed", "uniform", "lognormal"):
            raise ValueError(f"size_dist {self.size_dist!r}")
        if self.popularity not in ("zipf", "uniform"):
            raise ValueError(f"popularity {self.popularity!r}")
        if self.mode not in ("closed", "open"):
            raise ValueError(f"mode {self.mode!r}")
        if self.mode == "open" and self.target_qps <= 0:
            raise ValueError("open-loop mode needs target_qps > 0")
        total = self.read_frac + self.write_frac + self.rmw_frac
        if total <= 0:
            raise ValueError("op mix fractions sum to zero")
        width = self.ec_k + self.ec_m
        if self.pool_type == "erasure" and self.n_osds < width:
            raise ValueError(
                f"{self.n_osds} OSDs cannot host k+m={width} shards")
        return self

    def to_dict(self) -> dict:
        return asdict(self)

    # -- deterministic working set ------------------------------------------
    def object_name(self, i: int) -> str:
        return f"lg-{i:06d}"

    def object_size(self, i: int) -> int:
        """Per-object size, stable across the whole run (offsets into
        an object must stay valid however ops interleave)."""
        if self.size_dist == "fixed":
            return self.obj_size
        rnd = random.Random(f"{self.seed}:size:{i}")
        if self.size_dist == "uniform":
            return rnd.randrange(self.size_min, self.size_max + 1)
        # lognormal around obj_size, clamped into [size_min, size_max]
        v = int(rnd.lognormvariate(math.log(self.obj_size), 0.5))
        return max(self.size_min, min(self.size_max, v))

    def _popularity_weights(self) -> list[float]:
        if self.popularity == "uniform":
            return [1.0] * self.n_objects
        # Zipf over a seeded PERMUTATION of object indices: hot keys
        # land on arbitrary PGs, not pg 0
        rnd = random.Random(f"{self.seed}:perm")
        order = list(range(self.n_objects))
        rnd.shuffle(order)
        weights = [0.0] * self.n_objects
        for rank, idx in enumerate(order):
            weights[idx] = 1.0 / (rank + 1) ** self.zipf_s
        return weights

    # -- deterministic op schedule ------------------------------------------
    def schedule(self, n_ops: int | None = None,
                 salt: str = "steady") -> list[Op]:
        """The op stream: same (spec, salt) -> same list, always."""
        n_ops = self.n_ops if n_ops is None else n_ops
        rnd = random.Random(f"{self.seed}:{salt}")
        weights = self._popularity_weights()
        cum = list(itertools.accumulate(weights))
        total = self.read_frac + self.write_frac + self.rmw_frac
        t_read = self.read_frac / total
        t_write = t_read + self.write_frac / total
        ops: list[Op] = []
        for _ in range(n_ops):
            idx = rnd.choices(range(self.n_objects), cum_weights=cum,
                              k=1)[0]
            oid = self.object_name(idx)
            size = self.object_size(idx)
            r = rnd.random()
            if r < t_read:
                ops.append(Op("read", oid, 0, 0))
            elif r < t_write:
                ops.append(Op("write", oid, size, 0))
            else:
                span = min(self.rmw_bytes, size)
                off = rnd.randrange(0, size - span + 1)
                ops.append(Op("rmw", oid, span, off))
        return ops

    def preload_ops(self) -> Iterator[Op]:
        """One writefull per object — the working set."""
        for i in range(self.n_objects):
            yield Op("write", self.object_name(i),
                     self.object_size(i), 0)

    def schedule_digest(self, ops: list[Op]) -> str:
        """Stable fingerprint of an op schedule (report provenance:
        two runs reporting the same digest replayed the same ops)."""
        h = hashlib.sha256()
        for op in ops:
            h.update(f"{op.kind}|{op.oid}|{op.size}|{op.off}\n"
                     .encode())
        return h.hexdigest()[:16]


_PAYLOAD_BASE: dict[int, bytes] = {}


def payload_for(spec: WorkloadSpec, size: int) -> bytes:
    """Deterministic payload bytes: one seeded base buffer per spec
    seed, sliced per request — a 10k-object working set must not cost
    10k distinct random buffers (content only matters for byte
    accounting and CRC exercise, not entropy)."""
    if size <= 0:
        return b""
    base = _PAYLOAD_BASE.get(spec.seed, b"")
    if len(base) < size:
        want = max(size, spec.size_max, spec.obj_size)
        rnd = random.Random(f"{spec.seed}:payload")
        base = rnd.getrandbits(8 * want).to_bytes(want, "little")
        _PAYLOAD_BASE[spec.seed] = base
    return base[:size]
