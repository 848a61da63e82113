"""Cluster control plane: monitors own the maps.

The cluster map (``osdmap.OSDMap``) and its epoch placement table
(``pg_mapping.PGMapping`` over the bulk recompute ``bulk_crush_rows``),
and the monitor (``monitor.Monitor``) that holds the authoritative map,
its pools and EC profiles, commits changes through a paxos-lite
replicated log and publishes them to subscribers.  A map is carried
across from another implementation by its ``to_dict()`` and
``OSDMap.from_dict(d, device=...)``.
"""

from .osdmap import OSDMap, PoolSpec, Incremental  # noqa: F401
from .pg_mapping import PGMapping  # noqa: F401
from .monitor import Monitor  # noqa: F401
