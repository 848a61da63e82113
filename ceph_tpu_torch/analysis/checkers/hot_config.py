"""hot-path-config-read: no config lookups on the launch-loop paths.

The config-snapshot discipline: every knob the codec
batcher / mesh / EC read path consumes is read ONCE at construction
(``CodecBatcher.from_config``, the ECBackend ``osd_ec_read_*``
snapshot) and the hot loops never touch the config dict.  A
``conf.get`` that creeps back onto those paths re-adds a dict probe
chain per launch/read -- and worse, makes behavior racy against
runtime ``config set`` (half a batch under the old value, half under
the new).  This rule is the static closure of that discipline: from
the launch-loop entry points the dynamic no-lookup micro-assertions
watch, every function reachable through call edges of fan-out <= 4 is
"on the hot path", and a config read there is a finding.

The read heuristic matches the ``config-schema`` rule: a ``.get`` or
``[]`` whose receiver's leaf name is ``conf``/``config``/``cfg`` and
whose key is a snake_case option name.  The fix is always the same --
snapshot at construction and close over the value.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register

# the launch-loop entry points the config-snapshot discipline covers:
# the batcher submit/launch spine, the mesh launches, the batched
# StripeInfo drivers, the EC read path (runs per degraded read), the
# shard-cache hot entry points, the bulk CRUSH mapper and the CRC
# engines -- the same spine the dynamic micro-assertions watch
ROOTS = (
    "CodecBatcher.encode",
    "CodecBatcher.decode",
    "CodecBatcher.rmw",
    "CodecBatcher._submit",
    "CodecBatcher._run_batch",
    "MeshCodec.encode",
    "MeshCodec.decode",
    "MeshCodec.rmw",
    "StripeInfo.encode_async",
    "StripeInfo.decode_async",
    "StripeInfo.reconstruct_logical_async",
    "ECBackend._fetch_shards",
    "ECBackend._gather_shards",
    "ECBackend.collect_shard_states",
    # the recovery repair path (runs per rebuilt shard: fragment
    # pulls + full gathers) and the flat codec launch entry points --
    # the osd_ec_repair_fragments_enabled gate is snapshot at
    # construction, never read per repair
    "ECBackend.read_recovery_payload",
    "ECBackend._fragment_recover",
    "LinearSubchunkCodec.encode_batch",
    "LinearSubchunkCodec.decode_batch",
    "HedgedGather.gather_shards",
    "HedgedGather.first_reply",
    "DeviceShardCache.get",
    "DeviceShardCache.put",
    "VectorCrush.map_pgs",
    "crc32c_batch",
    "crc32c_rows",
)

MAX_FANOUT = 4

_RECEIVERS = {"conf", "config", "cfg"}
_KEY_RE = re.compile(r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)+$")


def _config_read(node: ast.AST) -> str | None:
    """The option key this node reads from a config receiver, if any."""
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args \
            and astutil.name_leaf(node.func.value) in _RECEIVERS:
        key = astutil.const_str(node.args[0])
    elif isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load) \
            and astutil.name_leaf(node.value) in _RECEIVERS:
        key = astutil.const_str(node.slice)
    else:
        return None
    if key is not None and _KEY_RE.match(key):
        return key
    return None


@register
class HotPathConfigRead(ProjectChecker):
    name = "hot-path-config-read"
    description = ("conf/config/cfg reads reachable from the launch-"
                   "loop entry points the config-snapshot discipline "
                   "covers (snapshot at construction instead)")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        roots: list[str] = []
        root_of: dict[str, str] = {}
        for spec in ROOTS:
            for qual in graph.lookup(spec):
                roots.append(qual)
                root_of[qual] = spec
        if not roots:
            return
        seen: dict[str, str] = {}
        stack = [(q, root_of[q]) for q in roots]
        while stack:
            cur, origin = stack.pop()
            if cur in seen:
                continue
            seen[cur] = origin
            for dst, fo in graph.calls.get(cur, {}).items():
                if fo <= MAX_FANOUT and dst not in seen \
                        and dst in graph.functions:
                    stack.append((dst, origin))
        for qual, origin in sorted(seen.items()):
            fi = graph.functions.get(qual)
            if fi is None:
                continue
            for node in own_nodes(fi.node):
                key = _config_read(node)
                if key is not None:
                    yield Finding(
                        fi.path, node.lineno, self.name,
                        f"config key '{key}' read on the launch-loop "
                        f"hot path (reachable from {origin}): a dict "
                        f"probe per launch, racy against runtime "
                        f"config set -- snapshot the value at "
                        f"construction (from_config / __init__) and "
                        f"close over it")
