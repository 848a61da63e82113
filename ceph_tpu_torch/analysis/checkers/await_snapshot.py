"""await-invalidates-snapshot: check-then-act across a suspension.

The single-asyncio-loop invariant every daemon leans on: between two
awaits, nobody else runs, so a local snapshot of shared mutable state
(``pg = self.pgs.get(pgid)``, ``conn = self.conns[addr]``) stays
coherent for straight-line code.  Every ``await`` is the hole in that
argument -- the loop runs peering, a kill, a revive, an epoch bump --
and in the multiprocess swarm the hole widens to "always".  The race
shape is bind -> await -> use:

    osd = self.osds[index]
    await something()          # the loop may remove/replace the osd
    osd.apply(...)             # acts on a snapshot of the past

Mechanics, per async function in ``osd/``, ``mon/``, ``loadgen/``:

* a *snapshot binding* is ``x = <root>[k]`` / ``x = <root>.get(k)``
  where the root is ``self``-rooted shared state or a module-level
  mutable global (the shared-state census's own definition);
* an ``await`` between the binding and a later use *suspends* when
  its operand is not a call, does not resolve in the project, or its
  fan-out <= 4 call-graph closure (``spawn=False``, the
  await-under-lock projection) contains a function that itself awaits
  outside the project -- sleep, a stream read, a future.  A call
  whose whole closure is project-local synchronous code provably
  cannot yield the loop and is exempt;
* re-binding the name after the await clears it (that IS the fix:
  re-read), and a lock region spanning both the binding and the use
  exempts the window (the mutators that matter serialize on the
  guarding lock).

Line-ordered, single-function approximation: a loop that carries a
snapshot across its back edge into the next iteration's await is not
modeled, and neither is a snapshot handed to a callee.  Both
directions are conservative-quiet, never noisy.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import (CallGraph, _Resolver, is_lock_name,
                         own_nodes)
from ..core import Finding
from ..registry import ProjectChecker, register

MAX_FANOUT = 4
_SCOPE = ("osd/", "mon/", "loadgen/")


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPE)


def _module_globals(tree: ast.AST) -> set[str]:
    """Names of module-level mutable containers (dict/list/set
    literals or mutable-builtin calls) -- snapshot roots."""
    out: set[str] = set()
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            v = stmt.value
            if isinstance(v, (ast.Dict, ast.List, ast.Set)):
                out.add(stmt.targets[0].id)
            elif isinstance(v, ast.Call):
                leaf = astutil.name_leaf(v.func)
                if leaf in ("dict", "list", "set", "defaultdict",
                            "OrderedDict"):
                    out.add(stmt.targets[0].id)
    return out


def _snapshot_source(value: ast.AST,
                     mod_globals: set[str]) -> str | None:
    """Dotted render of the shared container a binding snapshots
    from, or None when the binding is not a snapshot."""
    if isinstance(value, ast.Subscript):
        base = value.value
    elif (isinstance(value, ast.Call)
          and isinstance(value.func, ast.Attribute)
          and value.func.attr == "get" and value.args):
        base = value.func.value
    else:
        return None
    d = astutil.dotted(base)
    if d is None:
        return None
    head = d.split(".", 1)[0]
    if head == "self" and "." in d:
        return d
    if head in mod_globals and head == d:
        return d
    return None


class _SuspensionOracle:
    """Does awaiting this expression actually yield the event loop?"""

    def __init__(self, graph: CallGraph) -> None:
        self.graph = graph
        self._primitive: dict[str, bool] = {}
        self._closure: dict[tuple, bool] = {}

    def _has_primitive_await(self, qual: str) -> bool:
        """The function awaits something the project cannot resolve
        (sleep, a stream, a bare future) -- a true suspension point."""
        if qual in self._primitive:
            return self._primitive[qual]
        fi = self.graph.functions.get(qual)
        hit = False
        if fi is not None:
            syms = self.graph.symbols.get(fi.path)
            resolver = _Resolver(self.graph, syms) if syms else None
            for node in own_nodes(fi.node):
                if not isinstance(node, ast.Await):
                    continue
                v = node.value
                if not isinstance(v, ast.Call) or resolver is None:
                    hit = True
                    break
                targets = [d for d, fo in resolver.resolve_call(
                    v, fi.cls, []) if fo <= MAX_FANOUT]
                if not targets:
                    hit = True
                    break
        self._primitive[qual] = hit
        return hit

    def suspends(self, await_node: ast.Await, cls: str | None,
                 resolver: _Resolver) -> bool:
        v = await_node.value
        if not isinstance(v, ast.Call):
            return True                      # await fut / await x
        targets = tuple(sorted(
            d for d, fo in resolver.resolve_call(v, cls, [])
            if fo <= MAX_FANOUT))
        if not targets:
            return True                      # unknown callee
        if targets not in self._closure:
            closure = self.graph.reachable(
                list(targets), max_fanout=MAX_FANOUT, spawn=False)
            self._closure[targets] = any(
                self._has_primitive_await(q) for q in closure)
        return self._closure[targets]


def _bind_lines(root: ast.AST, name: str) -> list[int]:
    """Every line that (re)binds `name` in this function."""
    out = []
    for node in own_nodes(root):
        tgts = []
        if isinstance(node, (ast.Assign,)):
            tgts = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                               ast.NamedExpr)):
            tgts = [node.target]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            tgts = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            tgts = [i.optional_vars for i in node.items
                    if i.optional_vars is not None]
        for t in tgts:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name) and sub.id == name:
                    out.append(node.lineno)
    return sorted(set(out))


def _lock_spans(root: ast.AST) -> list[tuple[int, int]]:
    out = []
    for node in own_nodes(root):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            if is_lock_name(astutil.name_leaf(expr)):
                out.append((node.lineno,
                            node.end_lineno or node.lineno))
                break
    return out


def snapshot_races(graph: CallGraph) -> list[dict]:
    """Every bind -> suspending-await -> use window in scope.  Pure
    data; check_project turns these into findings."""
    oracle = _SuspensionOracle(graph)
    out: list[dict] = []
    for path in sorted(graph.symbols):
        if not _in_scope(path):
            continue
        syms = graph.symbols[path]
        resolver = _Resolver(graph, syms)
        mod_globals = _module_globals(syms.module.tree)
        for fi in syms.functions:
            if not fi.is_async:
                continue
            root = fi.node
            awaits = [n for n in own_nodes(root)
                      if isinstance(n, ast.Await)]
            if not awaits:
                continue
            # (lineno, end_lineno) spans: a "use" inside the await
            # expression's own argument list evaluates BEFORE the
            # suspension, so the hazard needs span_end < use
            susp_spans = sorted(
                (n.lineno, n.end_lineno or n.lineno) for n in awaits
                if oracle.suspends(n, fi.cls, resolver))
            if not susp_spans:
                continue
            locks = _lock_spans(root)
            bindings = []
            for node in own_nodes(root):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                src = _snapshot_source(node.value, mod_globals)
                if src is not None:
                    bindings.append((node.targets[0].id,
                                     node.lineno, src))
            for name, bline, src in bindings:
                rebinds = [ln for ln in _bind_lines(root, name)
                           if ln != bline]
                uses = sorted(
                    n.lineno for n in own_nodes(root)
                    if isinstance(n, ast.Name) and n.id == name
                    and isinstance(n.ctx, ast.Load)
                    and n.lineno > bline)
                race = None
                for use in uses:
                    last_bind = max([bline] + [ln for ln in rebinds
                                               if ln <= use])
                    if last_bind != bline:
                        break      # re-read: later uses are fresh
                    aw = next((lo for lo, hi in susp_spans
                               if last_bind < lo and hi < use), None)
                    if aw is None:
                        continue
                    if any(lo <= last_bind and use <= hi
                           for lo, hi in locks):
                        continue   # the guarding lock spans the window
                    race = {"path": path, "line": use,
                            "function": fi.local, "local": name,
                            "source": src, "bind_line": bline,
                            "await_line": aw, "use_line": use}
                    break
                if race is not None:
                    out.append(race)
    return out


@register
class AwaitInvalidatesSnapshot(ProjectChecker):
    name = "await-invalidates-snapshot"
    description = ("a local snapshot of shared mutable state used "
                   "after an await that can yield the event loop, "
                   "without a re-read or a spanning lock (check-"
                   "then-act race in osd/, mon/, loadgen/)")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        for r in snapshot_races(graph):
            yield Finding(
                r["path"], r["line"], self.name,
                f"'{r['local']}' snapshots {r['source']} at line "
                f"{r['bind_line']} but is used after the await at "
                f"line {r['await_line']} -- the event loop may have "
                f"mutated the source in between (await span "
                f"{r['bind_line']}->{r['use_line']}); re-read it, "
                f"hold the guarding lock across the window, or "
                f"justify the stale use")
