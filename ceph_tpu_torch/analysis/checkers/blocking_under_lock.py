"""blocking-under-lock: no synchronous stalls inside lock regions.

The OSD, messenger, and fault injector all run on one asyncio loop;
a ``time.sleep``, raw socket op, or ``Future.result()`` inside a
``with <lock>`` / ``async with <lock>`` region doesn't just stall the
holder -- it wedges every task queued on that lock *and* (being a
blocking call on the loop thread) the whole reactor, which is how a
slow peer turns into a cluster-wide heartbeat storm.

Scoped to ``osd/``, ``msg/`` and ``common/faults.py``.  A context
manager expression whose final identifier contains ``lock`` is
treated as a lock; nested ``def``s inside the region are skipped
(they execute later, not under the lock).
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..core import Finding, Module
from ..registry import Checker, register

_SOCKET_METHODS = {"accept", "connect", "connect_ex", "recv",
                   "recvfrom", "recv_into", "listen", "sendall"}
_SOCKET_BASES = {"socket"}


def _is_lock_expr(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        expr = expr.func            # e.g. `with self._lock_for(pg):`
    leaf = astutil.name_leaf(expr)
    return leaf is not None and "lock" in leaf.lower()


@register
class BlockingUnderLock(Checker):
    name = "blocking-under-lock"
    description = ("time.sleep / socket ops / Future.result() inside "
                   "a lock region in osd/, msg/, common/faults.py")

    def scope(self, module: Module) -> bool:
        p = module.path
        return ("osd/" in p or "msg/" in p
                or p.endswith("common/faults.py"))

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_is_lock_expr(item.context_expr)
                       for item in node.items):
                continue
            yield from self._scan_region(node, module)

    def _scan_region(self, region: ast.AST,
                     module: Module) -> Iterable[Finding]:
        stack: list[ast.AST] = list(region.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue            # runs later, not under the lock
            if isinstance(node, ast.Call):
                yield from self._check_call(node, module)
            stack.extend(ast.iter_child_nodes(node))

    def _check_call(self, node: ast.Call,
                    module: Module) -> Iterable[Finding]:
        name = astutil.dotted(node.func) or ""
        if name == "time.sleep" or name == "sleep":
            yield Finding(
                module.path, node.lineno, self.name,
                "time.sleep() while holding a lock stalls every "
                "waiter and blocks the event loop; sleep outside "
                "the region (or await asyncio.sleep outside it)")
            return
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            base = astutil.dotted(node.func.value) or ""
            if attr == "result" and not node.args:
                yield Finding(
                    module.path, node.lineno, self.name,
                    "Future.result() under a lock blocks the loop "
                    "thread until the future resolves -- and the "
                    "resolver may need this very lock (deadlock); "
                    "await it outside the region")
            elif (attr in _SOCKET_METHODS
                  and (base in _SOCKET_BASES
                       or "sock" in base.lower().rsplit(".", 1)[-1])):
                yield Finding(
                    module.path, node.lineno, self.name,
                    f"socket .{attr}() under a lock: network "
                    f"latency becomes lock hold time for every "
                    f"waiter; do the I/O outside the region")
            elif (attr in ("socket", "create_connection")
                  and base in _SOCKET_BASES):
                yield Finding(
                    module.path, node.lineno, self.name,
                    f"socket.{attr}() under a lock: connection "
                    f"setup blocks all waiters; do it outside the "
                    f"region")
