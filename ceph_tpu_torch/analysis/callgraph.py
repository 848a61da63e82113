"""Best-effort interprocedural call graph over a lint Project.

Edges come in two strengths, and every edge carries its *fan-out*:

* precise (fan-out 1): local/nested defs, module top-level functions,
  imported names, ``self.method`` resolved in the enclosing class (or
  a statically resolvable base class), ``alias.func`` through the
  import table, ``Class.method`` on a known class;
* fuzzy (fan-out N): an attribute call whose receiver cannot be
  typed resolves to every project function with that name -- N says
  how ambiguous the guess was.

Rules pick their own precision/recall point via ``max_fanout`` when
they traverse: a reachability rule guarding a hot path wants tight
edges (a call named ``encode`` that could be any of nine functions is
probably not the one you meant), while a liveness rule wants every
edge it can get (an over-approximated "reachable" is the safe
direction for dead-code detection).  Reference edges (a function name
mentioned without a call -- callbacks, handler tables, decorators)
are kept separately for the liveness side.

The graph also tags what the whole-program rules need beyond edges:
per-function async-ness (``FunctionInfo.is_async``) and lock regions
(every ``with``/``async with`` on a lock-like context manager, with
the calls made and locks taken while it is held).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import astutil
from .core import Project
from .project import (FunctionInfo, ModuleSymbols, collect_symbols)

# names so common that a fuzzy match is noise, not signal
_FUZZY_SKIP = {"get", "items", "keys", "values", "update", "close",
               "pop", "add", "append", "run", "start", "stop", "send",
               "put", "read", "write", "copy", "next", "clear", "set"}
_FUZZY_CAP = 24          # store at most this many targets per site

# callables that SCHEDULE their argument on another task instead of
# running it in the caller's activation: the inner call still becomes
# an edge (the code does run -- liveness must see it) but a *deferred*
# one, because the caller's locks are not held when it executes
_SPAWN_WRAPPERS = {"ensure_future", "create_task", "call_soon",
                   "call_later", "call_soon_threadsafe"}


def _call_base(func: ast.AST) -> str | None:
    """Base identifier of a (possibly chained) method call:
    ``enc.u32(x).u64`` -> ``enc``."""
    node = func
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    return node.id if isinstance(node, ast.Name) else None


def is_lock_name(leaf: str | None) -> bool:
    return leaf is not None and "lock" in leaf.lower()


@dataclass
class LockRegion:
    """One ``with <lock>:`` region and what happens while it is held."""

    locks: list[str]                 # ids of the locks this region takes
    owner: str                       # qualname of the holding function
    path: str
    line: int
    is_async: bool
    callees: list[tuple[str, int]] = field(default_factory=list)
    inner_locks: list[str] = field(default_factory=list)


class CallGraph:
    """The project call graph plus the symbol table it was built from."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.symbols: dict[str, ModuleSymbols] = collect_symbols(project)
        self.functions: dict[str, FunctionInfo] = {}
        self.by_name: dict[str, list[str]] = {}
        self.module_by_dotted: dict[str, ModuleSymbols] = {}
        # src qualname -> {dst qualname: fanout of the resolving site}
        self.calls: dict[str, dict[str, int]] = {}
        # edges that ONLY occur through a spawn wrapper (ensure_future
        # / create_task): real for liveness, not for lock analysis
        self.spawn_only: dict[str, set[str]] = {}
        self.refs: dict[str, set[str]] = {}
        self.lock_regions: list[LockRegion] = []
        self._rcalls: dict[str, dict[str, int]] | None = None

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, project: Project) -> "CallGraph":
        g = cls(project)
        for syms in g.symbols.values():
            g.module_by_dotted[syms.dotted] = syms
            for fi in syms.functions:
                g.functions[fi.qualname] = fi
                g.by_name.setdefault(fi.name, []).append(fi.qualname)
        for syms in g.symbols.values():
            _Resolver(g, syms).resolve()
        return g

    def module_root(self, path: str) -> str:
        """Pseudo-function id for a module's top-level code."""
        return f"{path}::<module>"

    def _edge(self, src: str, dst: str, fanout: int,
              spawned: bool = False) -> None:
        cur = self.calls.setdefault(src, {})
        prev = cur.get(dst)
        if prev is None:
            if spawned:
                self.spawn_only.setdefault(src, set()).add(dst)
        elif not spawned:
            self.spawn_only.get(src, set()).discard(dst)
        if prev is None or fanout < prev:
            cur[dst] = fanout
            self._rcalls = None

    def _ref(self, src: str, dst: str) -> None:
        self.refs.setdefault(src, set()).add(dst)

    # -- queries -------------------------------------------------------------
    def lookup(self, spec: str) -> list[str]:
        """Qualnames matching ``Class.method`` or ``func`` anywhere in
        the project (how rules name their entry points)."""
        out = []
        for qual, fi in self.functions.items():
            if fi.local == spec or (fi.cls and
                                    f"{fi.cls}.{fi.name}" == spec):
                out.append(qual)
            elif "." not in spec and fi.cls is None \
                    and fi.local == spec:
                out.append(qual)
        return sorted(set(out))

    def reachable(self, roots, *, max_fanout: int = 10**6,
                  refs: bool = False, spawn: bool = True) -> set[str]:
        """Forward transitive closure over call edges (and optionally
        reference edges) whose fan-out is within ``max_fanout``.
        ``spawn=False`` skips edges that only exist through a task
        spawn (ensure_future/create_task) -- the traversal then means
        "runs in the caller's activation", which is what lock-holding
        analysis needs."""
        seen = set()
        stack = [r for r in roots]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            spawned = self.spawn_only.get(cur, ())
            for dst, fo in self.calls.get(cur, {}).items():
                if not spawn and dst in spawned:
                    continue
                if fo <= max_fanout and dst not in seen:
                    stack.append(dst)
            if refs:
                for dst in self.refs.get(cur, ()):
                    if dst not in seen:
                        stack.append(dst)
        return seen

    def callers(self, targets, *, max_fanout: int = 10**6) -> set[str]:
        """Reverse transitive closure: every function from which some
        target is reachable (targets themselves included)."""
        if self._rcalls is None:
            rc: dict[str, dict[str, int]] = {}
            for src, dsts in self.calls.items():
                for dst, fo in dsts.items():
                    cur = rc.setdefault(dst, {})
                    if fo < cur.get(src, 10**9):
                        cur[src] = fo
            self._rcalls = rc
        seen = set()
        stack = list(targets)
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for src, fo in self._rcalls.get(cur, {}).items():
                if fo <= max_fanout and src not in seen:
                    stack.append(src)
        return seen

    def entry_points(self) -> set[str]:
        """Liveness roots: module top-level code plus every function
        whose name is public API shaped (no leading underscore, or a
        dunder), a test, or a main."""
        roots: set[str] = set()
        for path in self.symbols:
            roots.add(self.module_root(path))
        for qual, fi in self.functions.items():
            n = fi.name
            if (not n.startswith("_")
                    or (n.startswith("__") and n.endswith("__"))
                    or n.startswith("test_") or n == "main"):
                roots.add(qual)
        return roots


def own_nodes(root: ast.AST):
    """Walk a function (or module) body without descending into nested
    function definitions -- their statements run on a different
    activation, so they belong to their own FunctionInfo."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # decorators/defaults evaluate in the enclosing scope
            stack.extend(node.decorator_list)
            stack.extend(d for d in node.args.defaults if d)
            continue
        stack.extend(ast.iter_child_nodes(node))


def _literal_prefix(node: ast.AST) -> str | None:
    """Leading constant of a dynamic attribute name: the f-string
    ``f"_h_{t}"`` and the concat ``"_h_" + t`` both yield ``"_h_"``."""
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if (isinstance(first, ast.Constant)
                and isinstance(first.value, str)
                and len(node.values) > 1):
            return first.value
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)
            and isinstance(node.left, ast.Constant)
            and isinstance(node.left.value, str)):
        return node.left.value
    return None


def _spawn_wrapped_ids(root: ast.AST) -> set[str]:
    """ids of every Call node inside the arguments of a spawn wrapper
    (``ensure_future(self._loop(c))``: the inner call creates the
    coroutine, the wrapper schedules it on another task)."""
    out: set[int] = set()
    for node in own_nodes(root):
        if not (isinstance(node, ast.Call)
                and astutil.name_leaf(node.func) in _SPAWN_WRAPPERS):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call):
                    out.add(id(sub))
    return out


class _Resolver:
    """Second pass: turn one module's call sites into graph edges."""

    def __init__(self, graph: CallGraph, syms: ModuleSymbols) -> None:
        self.g = graph
        self.syms = syms
        self.path = syms.module.path

    def resolve(self) -> None:
        mod_qual = self.g.module_root(self.path)
        self._resolve_body(self.syms.module.tree, mod_qual,
                           cls=None, locals_chain=[])
        for fi in self.syms.functions:
            self._resolve_body(fi.node, fi.qualname, cls=fi.cls,
                               locals_chain=self._local_defs(fi))
            self._collect_lock_regions(fi)
            # a def is an edge: the nested function can only run if
            # its enclosing function ran (conservative for liveness)
            for child in ast.walk(fi.node):
                if child is fi.node:
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    nested = f"{self.path}::" + self._nested_local(
                        fi, child)
                    if nested in self.g.functions:
                        self.g._edge(fi.qualname, nested, 1)

    def _nested_local(self, outer: FunctionInfo,
                      node: ast.AST) -> str:
        # nested defs were registered as "<outer>.<locals>.<name>";
        # deeper nesting chains the same suffix
        for cand in self.g.by_name.get(node.name, ()):
            fi = self.g.functions[cand]
            if fi.node is node:
                return fi.local
        return f"{outer.local}.<locals>.{node.name}"

    def _local_defs(self, fi: FunctionInfo) -> list[dict[str, str]]:
        out: dict[str, str] = {}
        for child in ast.iter_child_nodes(fi.node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                for cand in self.g.by_name.get(child.name, ()):
                    if self.g.functions[cand].node is child:
                        out[child.name] = cand
                        break
        return [out] if out else []

    # -- body walk -----------------------------------------------------------
    def _resolve_body(self, root, src: str, cls, locals_chain) -> None:
        spawned_ids = _spawn_wrapped_ids(root)
        call_funcs = set()
        for node in own_nodes(root):
            if isinstance(node, ast.Call):
                call_funcs.add(id(node.func))
                self._dynamic_dispatch(node, src)
                for dst, fo in self.resolve_call(node, cls,
                                                locals_chain):
                    self.g._edge(src, dst, fo,
                                 spawned=id(node) in spawned_ids)
        # reference edges: function names mentioned outside call
        # position (handler tables, callbacks, decorators)
        for node in own_nodes(root):
            if id(node) in call_funcs:
                continue
            leaf = astutil.name_leaf(node)
            if leaf and leaf in self.g.by_name:
                for dst in self.g.by_name[leaf][:_FUZZY_CAP]:
                    self.g._ref(src, dst)

    def _dynamic_dispatch(self, node: ast.Call, src: str) -> None:
        """``getattr(x, f"_h_{t}")`` / ``getattr(x, "_h_" + t)``: a
        dispatch-by-name-prefix convention.  Every function whose name
        starts with the literal prefix gets a reference edge -- the
        handlers ARE live, the table is just spelled dynamically."""
        if not (isinstance(node.func, ast.Name)
                and node.func.id == "getattr" and len(node.args) >= 2):
            return
        prefix = _literal_prefix(node.args[1])
        if prefix is None or len(prefix) < 2:
            return
        for name, quals in self.g.by_name.items():
            if name.startswith(prefix):
                for dst in quals[:_FUZZY_CAP]:
                    self.g._ref(src, dst)

    # -- call resolution -----------------------------------------------------
    def resolve_call(self, node: ast.Call, cls,
                     locals_chain) -> list[tuple[str, int]]:
        func = node.func
        dotted = astutil.dotted(func)
        if dotted is None:
            if isinstance(func, ast.Attribute):
                return self._fuzzy(func.attr)
            return []
        if "." not in dotted:
            return self._resolve_bare(dotted, locals_chain)
        head, _, rest = dotted.partition(".")
        leaf = dotted.rsplit(".", 1)[1]
        if head in ("self", "cls") and cls and "." not in rest:
            hit = self._resolve_method(cls, rest, set())
            if hit:
                return [(hit, 1)]
            return self._fuzzy(rest, methods_only=True)
        # alias/module-qualified: np.asarray, mod.func, Class.method
        expanded = self.syms.expand_alias(head)
        target = (expanded + "." + rest) if rest else expanded
        prefix, _, tleaf = target.rpartition(".")
        hit = self._resolve_dotted(prefix, tleaf)
        if hit:
            return [(hit, 1)]
        return self._fuzzy(leaf)

    def _resolve_bare(self, name, locals_chain) -> list[tuple[str, int]]:
        for frame in locals_chain:
            if name in frame:
                return [(frame[name], 1)]
        fi = self.syms.top_funcs.get(name)
        if fi:
            return [(fi.qualname, 1)]
        ci = self.syms.classes.get(name)
        if ci:
            init = ci.methods.get("__init__")
            return [(init.qualname, 1)] if init else []
        target = self.syms.aliases.get(name)
        if target:
            prefix, _, leaf = target.rpartition(".")
            hit = self._resolve_dotted(prefix, leaf)
            if hit:
                return [(hit, 1)]
        return []

    def _resolve_dotted(self, prefix: str, leaf: str) -> str | None:
        """``prefix.leaf`` as module.func, module.Class (-> __init__),
        package.module.Class.method, or local Class.method."""
        syms = self.g.module_by_dotted.get(prefix)
        if syms is not None:
            fi = syms.top_funcs.get(leaf)
            if fi:
                return fi.qualname
            ci = syms.classes.get(leaf)
            if ci:
                init = ci.methods.get("__init__")
                return init.qualname if init else None
            return None
        # prefix may itself be a class: "…mod.Class" + method leaf
        mod_prefix, _, cls_name = prefix.rpartition(".")
        csyms = (self.g.module_by_dotted.get(mod_prefix)
                 if mod_prefix else self.syms)
        if cls_name and csyms is not None:
            ci = csyms.classes.get(cls_name)
            if ci and leaf in ci.methods:
                return ci.methods[leaf].qualname
        # bare "Class.method" in this module
        ci = self.syms.classes.get(prefix)
        if ci and leaf in ci.methods:
            return ci.methods[leaf].qualname
        return None

    def _resolve_method(self, cls_name: str, meth: str,
                        seen: set) -> str | None:
        """Walk the statically visible inheritance chain."""
        if cls_name in seen:
            return None
        seen.add(cls_name)
        ci = self.syms.classes.get(cls_name)
        if ci is None:
            return None
        if meth in ci.methods:
            return ci.methods[meth].qualname
        for base in ci.bases:
            head, _, rest = base.partition(".")
            expanded = self.syms.expand_alias(head)
            target = (expanded + "." + rest) if rest else expanded
            mod, _, bcls = target.rpartition(".")
            bsyms = self.g.module_by_dotted.get(mod)
            if bsyms is not None:
                bci = bsyms.classes.get(bcls)
                if bci and meth in bci.methods:
                    return bci.methods[meth].qualname
            elif base in self.syms.classes:
                hit = self._resolve_method(base, meth, seen)
                if hit:
                    return hit
        return None

    def _fuzzy(self, leaf: str,
               methods_only: bool = False) -> list[tuple[str, int]]:
        if leaf in _FUZZY_SKIP:
            return []
        cands = self.g.by_name.get(leaf, [])
        if methods_only:
            cands = [q for q in cands
                     if self.g.functions[q].cls is not None]
        if not cands:
            return []
        fo = len(cands)
        return [(q, fo) for q in cands[:_FUZZY_CAP]]

    # -- lock regions --------------------------------------------------------
    def _collect_lock_regions(self, fi: FunctionInfo) -> None:
        for node in own_nodes(fi.node):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locks = []
            for item in node.items:
                lid = self._lock_id(item.context_expr, fi)
                if lid:
                    locks.append(lid)
            if not locks:
                continue
            region = LockRegion(
                locks=locks, owner=fi.qualname, path=self.path,
                line=node.lineno,
                is_async=isinstance(node, ast.AsyncWith))
            locals_chain = self._local_defs(fi)
            spawned_ids = _spawn_wrapped_ids(node)
            for inner in own_nodes(node):
                if isinstance(inner, ast.Call):
                    # a call handed to ensure_future/create_task runs
                    # on its own task -- this region's locks are not
                    # held across it
                    if id(inner) in spawned_ids:
                        continue
                    region.callees.extend(
                        self.resolve_call(inner, fi.cls, locals_chain))
                elif isinstance(inner, (ast.With, ast.AsyncWith)):
                    for item in inner.items:
                        lid = self._lock_id(item.context_expr, fi)
                        if lid:
                            region.inner_locks.append(lid)
            self.g.lock_regions.append(region)

    def _lock_id(self, expr: ast.AST, fi: FunctionInfo) -> str | None:
        if isinstance(expr, ast.Call):
            expr = expr.func
        leaf = astutil.name_leaf(expr)
        if not is_lock_name(leaf):
            return None
        base = _call_base(expr) if isinstance(expr, ast.Attribute) \
            else None
        if base in ("self", "cls") and fi.cls:
            return f"{fi.cls}.{leaf}"
        if isinstance(expr, ast.Name):
            return f"{self.path}:{leaf}"
        dotted = astutil.dotted(expr)
        return dotted or f"{self.path}:{leaf}"
