"""cross-daemon-state: the process-seam census and boundary rule.

The multiprocess-swarm refactor (ROADMAP) moves each daemon onto its
own worker process with the messenger as the only seam.  Everything
that works today *because* one asyncio loop serializes one address
space breaks silently there, in two shapes this rule makes visible:

* **shared mutable module/class state** -- compile caches, perf
  singletons, tuned tables.  These are censused (``--seam-report``)
  and classified: a fork-safe *recomputable cache* (each process
  rebuilds its own copy at worst-case a recompile) vs a *per-process
  counter* (aggregation must move to the seam) vs *correctness state*
  (two processes diverge silently).  The census is an artifact, not a
  finding -- having a cache is fine; the swarm PR needs the worklist.

* **daemon-boundary reaches** -- code outside a daemon's own
  subsystem reading its private attributes, grabbing a live subsystem
  object (``osd.pgs``, ``mon.osdmap``, a store, a messenger), or
  mutating its attributes.  In-process these are harmless shortcuts;
  across processes they are dangling references.  These ARE findings:
  route them through the Messenger or a public accessor, or justify
  the in-process shortcut with a ``# lint: disable`` comment.

Receiver typing is by the repo's naming conventions (a variable named
``osd``/``mon``/``pg``, a ``.mon`` attribute chain, iteration over an
``.osds``/``.pgs`` container) -- the same best-effort contract as the
call graph.  A reach is *internal* (not a finding) when it happens in
a method of the daemon class itself or in the daemon's home subsystem
directory (``osd/`` for OSD and PG, ``mon/`` for Monitor): peering
code in ``osd/pg.py`` touching ``self.osd.osdmap`` rides the same
process as the OSD by construction, the chaos driver does not.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register

DAEMON_CLASSES = ("OSD", "Monitor", "PG")

# the daemon's home subsystem dir: reaches from inside it share the
# daemon's process by construction in the swarm plan (one worker owns
# the whole subsystem), reaches from anywhere else cross the seam
DAEMON_HOME = {"OSD": "osd/", "PG": "osd/", "Monitor": "mon/"}

# live subsystem objects: handing one across the seam hands out state
# that will be another process's memory in the swarm
SUBSYSTEM_ATTRS = {"osdmap", "msgr", "pgs", "store", "conns",
                   "subop_pipe", "pg_log"}

# conventionally daemon-typed receiver names / attribute leaves
NAME_TYPES = {"osd": "OSD", "victim": "OSD", "mon": "Monitor",
              "monitor": "Monitor", "pg": "PG"}
# containers whose elements are daemon-typed (iteration / subscript)
CONTAINER_ATTRS = {"osds": "OSD", "pgs": "PG", "mons": "Monitor"}

# census: value expressions that denote shared mutable state
_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.DictComp,
                     ast.ListComp, ast.SetComp)
_MUTABLE_BUILTINS = {"dict", "list", "set", "bytearray", "deque",
                     "defaultdict", "OrderedDict", "Counter"}
_IMMUTABLE_CALLS = {"int", "float", "str", "bool", "bytes", "tuple",
                    "frozenset", "len", "calcsize", "namedtuple",
                    "TypeVar", "getenv", "compile", "frozen"}

_CACHE_HINTS = ("cache", "memo", "table", "compiled", "tuned", "plan",
                "sched", "shared", "registry", "plugin")
_COUNTER_HINTS = ("perf", "stats", "counter", "metric", "hist")
_PRIMITIVE_HINTS = ("lock", "sem", "cond", "event")

# container mutator methods: calling one on a module-global is the
# mutation evidence that separates shared state from a constant table
_MUTATORS = {"append", "add", "update", "setdefault", "pop",
             "popitem", "clear", "extend", "remove", "discard",
             "insert", "appendleft"}


def _mutated_names(graph: CallGraph) -> set[str]:
    """Leaf names with project-wide mutation evidence: a subscript
    store/delete, an augmented assignment, or a mutator-method call.
    A module-level dict nobody ever writes is a constant lookup
    table, not shared state."""
    out: set[str] = set()
    for syms in graph.symbols.values():
        for node in ast.walk(syms.module.tree):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, (ast.Store, ast.Del))):
                leaf = astutil.name_leaf(node.value)
                if leaf:
                    out.add(leaf)
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if isinstance(t, ast.Subscript):
                    t = t.value
                leaf = astutil.name_leaf(t)
                if leaf:
                    out.add(leaf)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MUTATORS):
                leaf = astutil.name_leaf(node.func.value)
                if leaf:
                    out.add(leaf)
    return out


def _is_mutable_value(v: ast.AST) -> str | None:
    """Kind of shared mutable state a top-level value denotes, or
    None for plainly immutable initializers."""
    if isinstance(v, _MUTABLE_LITERALS):
        return "container"
    if isinstance(v, ast.Call):
        leaf = astutil.name_leaf(v.func)
        if leaf is None or leaf in _IMMUTABLE_CALLS:
            return None
        if leaf in _MUTABLE_BUILTINS:
            return "container"
        if leaf.lstrip("_")[:1].isupper():
            return "instance"
    return None


def classify_state(name: str, kind: str) -> str:
    """fork-safe recomputable cache vs per-process counter vs
    per-process primitive vs correctness state (the swarm-PR triage
    split; the default is the conservative one)."""
    n = name.lower()
    if any(h in n for h in _PRIMITIVE_HINTS):
        return "per-process-primitive"
    if any(h in n for h in _COUNTER_HINTS):
        return "per-process-counter"
    if any(h in n for h in _CACHE_HINTS):
        return "fork-safe-cache"
    return "correctness-state"


def shared_state_census(graph: CallGraph) -> list[dict]:
    """Every module-level mutable global and mutable class attribute
    in the project, classified.  Pure data for ``--seam-report``.
    Module-global containers need project-wide mutation evidence
    (``_mutated_names``); instances (singleton objects) and class
    attributes are censused unconditionally."""
    mutated = _mutated_names(graph)
    out: list[dict] = []
    for path in sorted(graph.symbols):
        tree = graph.symbols[path].module.tree
        for stmt in tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if len(targets) != 1 or stmt.value is None:
                    continue
                t = targets[0]
                if not isinstance(t, ast.Name):
                    continue
                kind = _is_mutable_value(stmt.value)
                if kind is None:
                    continue
                if kind == "container" and t.id not in mutated:
                    continue          # constant lookup table
                out.append({
                    "path": path, "line": stmt.lineno, "name": t.id,
                    "kind": f"module-global-{kind}",
                    "classification": classify_state(t.id, kind)})
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if not (isinstance(sub, ast.Assign)
                            and len(sub.targets) == 1
                            and isinstance(sub.targets[0], ast.Name)):
                        continue
                    kind = _is_mutable_value(sub.value)
                    if kind is None:
                        continue
                    if (kind == "container"
                            and sub.targets[0].id not in mutated):
                        continue      # constant lookup table
                    name = f"{stmt.name}.{sub.targets[0].id}"
                    out.append({
                        "path": path, "line": sub.lineno,
                        "name": name,
                        "kind": f"class-attr-{kind}",
                        "classification": classify_state(name, kind)})
    return out


def _receiver_daemon(v: ast.AST, varmap: dict[str, str]) -> str | None:
    """Daemon class a receiver expression denotes, by convention."""
    if isinstance(v, ast.Name):
        return varmap.get(v.id) or NAME_TYPES.get(v.id)
    if isinstance(v, ast.Attribute):
        # self.mon / cluster.mon / self.osd ... the leaf names the role
        return NAME_TYPES.get(v.attr)
    if isinstance(v, ast.Subscript):
        return CONTAINER_ATTRS.get(astutil.name_leaf(v.value))
    return None


def _daemon_vars(root: ast.AST) -> dict[str, str]:
    """Locals typed as daemons by how they were bound: iteration over
    (or subscript into) a conventional daemon container."""
    out: dict[str, str] = {}

    def _bind(target, it) -> None:
        if not isinstance(target, ast.Name):
            return
        if isinstance(it, ast.Call):      # .values() / sorted(...)
            base = it.func
            if (isinstance(base, ast.Attribute)
                    and base.attr in ("values", "list")):
                it = base.value
            else:
                return
        leaf = astutil.name_leaf(it)
        d = CONTAINER_ATTRS.get(leaf)
        if d:
            out[target.id] = d

    for node in own_nodes(root):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            _bind(node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            _bind(node.target, node.iter)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.value, ast.Subscript)):
            leaf = astutil.name_leaf(node.value.value)
            d = CONTAINER_ATTRS.get(leaf)
            if d and isinstance(node.targets[0], ast.Name):
                out[node.targets[0].id] = d
    return out


def daemon_reaches(graph: CallGraph) -> list[dict]:
    """Every site where code outside a daemon's home touches its
    private/subsystem/mutated attributes.  Pure data; check_project
    turns these into findings."""
    out: list[dict] = []
    seen: set[tuple] = set()
    for path in sorted(graph.symbols):
        syms = graph.symbols[path]
        contexts = [(graph.module_root(path),
                     syms.module.tree, None)]
        contexts += [(fi.qualname, fi.node, fi.cls)
                     for fi in syms.functions]
        for qual, root, cls in contexts:
            varmap = _daemon_vars(root)
            for node in own_nodes(root):
                if not isinstance(node, ast.Attribute):
                    continue
                daemon = _receiver_daemon(node.value, varmap)
                if daemon is None:
                    continue
                if cls == daemon or DAEMON_HOME[daemon] in path:
                    continue               # the daemon's own process
                attr = node.attr
                write = isinstance(node.ctx, (ast.Store, ast.Del))
                private = (attr.startswith("_")
                           and not attr.startswith("__"))
                if not (write or private or attr in SUBSYSTEM_ATTRS):
                    continue
                key = (path, node.lineno, daemon, attr, write)
                if key in seen:
                    continue
                seen.add(key)
                out.append({
                    "path": path, "line": node.lineno,
                    "daemon": daemon, "attr": attr,
                    "access": "write" if write else "read",
                    "private": private, "context": qual})
    return out


def reach_origin_daemons(graph: CallGraph, qual: str,
                         max_fanout: int = 6) -> set[str]:
    """Daemon classes whose code can reach the function holding a
    boundary reach (reverse closure over call edges): a reach in a
    shared helper is charged to every daemon that can run it."""
    out: set[str] = set()
    for q in graph.callers([qual], max_fanout=max_fanout):
        fi = graph.functions.get(q)
        if fi is not None and fi.cls in DAEMON_CLASSES:
            out.add(fi.cls)
    return out


@register
class CrossDaemonState(ProjectChecker):
    name = "cross-daemon-state"
    description = ("direct reads/writes of another daemon's private "
                   "or live-subsystem attributes instead of crossing "
                   "the Messenger (dangling references in a "
                   "multiprocess fleet); censuses shared mutable "
                   "globals for --seam-report")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        for r in daemon_reaches(graph):
            attr, daemon = r["attr"], r["daemon"]
            if r["access"] == "write":
                what = (f"mutates {daemon}.{attr} from outside the "
                        f"daemon -- a cross-daemon write has no "
                        f"meaning once each daemon owns a process")
            elif r["private"]:
                what = (f"reaches into {daemon} private state "
                        f"'.{attr}' -- add a public accessor; "
                        f"another daemon's internals are another "
                        f"process's memory in the swarm")
            else:
                what = (f"grabs {daemon}'s live '{attr}' subsystem "
                        f"across the daemon boundary -- route "
                        f"through the Messenger or a public "
                        f"accessor")
            yield Finding(r["path"], r["line"], self.name, what)
