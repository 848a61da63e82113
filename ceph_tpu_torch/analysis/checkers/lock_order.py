"""lock-order: one global acquisition order across call chains.

``blocking-under-lock`` sees a single function; the deadlock class it
cannot see is *ordering*: coroutine 1 holds lock A and awaits a call
chain that takes lock B, while coroutine 2 holds B and reaches for A
-- the acquisitions live in different functions, often different
modules, and each region looks innocent in isolation.  This rule
projects every lock region through the call graph: while region R
holds lock L, the locks acquired by R's nested ``with`` blocks plus
every lock region owned by a function reachable from R's call sites
(fan-out <= 4) form "L is held while X is taken" edges.  A cycle in
that edge graph is a lock-order inversion.

Lock identity is best-effort by name: ``self._foo_lock`` in class C
is ``C._foo_lock`` everywhere, so different *instances* of one class
collapse into one lock -- which is exactly the granularity a global
order is defined over.  Self-edges (L held while L is taken) are
skipped: across two instances of a class that is legal, and the
name-based identity cannot tell instances apart.

Scoped to ``osd/``, ``mon/``, ``msg/`` -- the daemons that share the
event loop and take each other's locks across message handlers.
"""

from __future__ import annotations

from typing import Iterable

from ..callgraph import CallGraph
from ..core import Finding
from ..registry import ProjectChecker, register

MAX_FANOUT = 4
_SCOPE = ("osd/", "mon/", "msg/")


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPE)


@register
class LockOrder(ProjectChecker):
    name = "lock-order"
    description = ("conflicting lock-acquisition orders across call "
                   "chains in osd/, mon/, msg/ (interprocedural "
                   "deadlock ordering)")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        regions = [r for r in graph.lock_regions
                   if _in_scope(r.path)]
        if not regions:
            return
        # locks acquired anywhere inside a function (for closures)
        owner_locks: dict[str, list[str]] = {}
        for r in graph.lock_regions:
            owner_locks.setdefault(r.owner, []).extend(r.locks)
        # held-while-acquiring edges with a witness site each
        edges: dict[tuple[str, str], tuple[str, int]] = {}

        def add(a: str, b: str, path: str, line: int) -> None:
            if a != b:
                edges.setdefault((a, b), (path, line))

        for r in regions:
            inner = list(r.inner_locks)
            callee_set = set()
            for dst, fo in r.callees:
                if fo <= MAX_FANOUT:
                    callee_set.add(dst)
            if callee_set:
                # spawn=False: a lock taken on a task the region only
                # *scheduled* is not taken while this lock is held
                for qual in graph.reachable(callee_set,
                                            max_fanout=MAX_FANOUT,
                                            spawn=False):
                    inner.extend(owner_locks.get(qual, ()))
            # multi-item `with a, b:` acquires in item order
            for i, a in enumerate(r.locks):
                for b in r.locks[i + 1:]:
                    add(a, b, r.path, r.line)
            for held in r.locks:
                for taken in inner:
                    add(held, taken, r.path, r.line)

        adj: dict[str, set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        for a, b in sorted(edges):
            if a < b and (b, a) in edges:
                pa, la = edges[(a, b)]
                pb, lb = edges[(b, a)]
                yield Finding(
                    pa, la, self.name,
                    f"lock-order inversion: '{a}' is held while "
                    f"'{b}' is taken here, but '{b}' is held while "
                    f"'{a}' is taken at {pb}:{lb} -- two coroutines "
                    f"interleaving these chains deadlock; pick one "
                    f"global order")
        # longer cycles with no pairwise inversion (A->B->C->A)
        for cycle in _simple_cycles(adj):
            if len(cycle) < 3:
                continue
            a, b = cycle[0], cycle[1]
            path, line = edges[(a, b)]
            chain = " -> ".join(cycle + [cycle[0]])
            yield Finding(
                path, line, self.name,
                f"lock-order cycle: {chain} -- the acquisitions live "
                f"in different functions but close a ring; pick one "
                f"global order")


def _simple_cycles(adj: dict[str, set[str]]) -> list[list[str]]:
    """Minimal deterministic cycle enumeration: one canonical cycle
    per strongly connected component of size >= 3."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) >= 3:
                sccs.append(sorted(comp))
    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    out = []
    for comp in sccs:
        members = set(comp)
        # walk a cycle within the component, greedily smallest-first
        cycle = [comp[0]]
        seen = {comp[0]}
        cur = comp[0]
        while True:
            nxts = sorted(n for n in adj.get(cur, ())
                          if n in members)
            if not nxts:
                break
            nxt = next((n for n in nxts if n not in seen), nxts[0])
            if nxt in seen:
                if nxt == cycle[0]:
                    out.append(cycle)
                break
            cycle.append(nxt)
            seen.add(nxt)
            cur = nxt
    return out
