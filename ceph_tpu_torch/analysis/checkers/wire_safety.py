"""wire-safety: everything that enters a Message must survive a wire.

Today the messenger loops frames back inside one process, so a
payload can smuggle anything -- a future, a bound method, a live jax
Array or torch tensor -- and the receiver gets the very same object.  Across the
multiprocess seam (shared-memory ring or socketpair) only *data*
crosses: the denc codecs serialize plain values, and anything tied to
the sending process's event loop, heap, or device client is garbage
on the other side.

The rule censuses every ``Message(type, {...})`` construction in the
tree (the construction site is where the payload's provenance is
visible; by the time ``Messenger.send``/``SubOpPipe.stage`` sees the
message it is an opaque dict) and flags payload fields whose value is
inferred to be non-wire-safe:

* an un-awaited coroutine (a call that resolves, at fan-out 1, to an
  ``async def``),
* an asyncio future/task (``ensure_future``/``create_task``/
  ``Future()``),
* a synchronization primitive (``Lock``/``Event``/``Semaphore``/
  ``Condition``),
* a live jax Array (a producer call resolving through the import
  table into ``jax``/``jax.numpy``), or in the port a live torch tensor
  (a producer call resolving into ``torch``), whose memory may be the
  card's,
* a bound method (``self.handler`` passed uncalled).

The census side (``--seam-report``) records every constructed wire
type with its codec verdict: ``typed`` (an explicit MOSDOp-style
layout in ``WIRE_CODECS``), ``control`` (``__``-prefixed messenger
internals), or ``generic`` (rides the tagged-value denc encoding),
plus which types the dispatch side consumes (``msg.type == "..."``
comparisons, ``_h_<type>`` handler methods, or a waiter queue keyed
by the request type a ``*_reply``/``*_ack`` name answers).  A
constructed type nobody consumes IS a finding: dead wire vocabulary,
or a sender whose reply silently hangs.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, _Resolver, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register

MAX_FANOUT = 1        # a coroutine verdict wants an unambiguous callee

_FUTURE_CALLS = {"ensure_future", "create_task"}
_SYNC_PRIMITIVES = {"Lock", "RLock", "Semaphore", "BoundedSemaphore",
                    "Event", "Condition", "Barrier", "Queue"}


def _module_str_consts(tree: ast.AST) -> dict[str, str]:
    """Top-level ``NAME = "literal"`` bindings (message-type
    constants like ACK_TYPE)."""
    out: dict[str, str] = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            s = astutil.const_str(stmt.value)
            if s is not None:
                out[stmt.targets[0].id] = s
    return out


def _local_values(root: ast.AST) -> dict[str, ast.AST]:
    """name -> value expression for single-assignment locals, so
    ``data = {...}; Message(t, data)`` (and an unsafe value bound to
    a name first) are as visible as the inline form."""
    out: dict[str, ast.AST] = {}
    dead: set[str] = set()
    for node in own_nodes(root):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            if name in out or name in dead:
                dead.add(name)       # reassigned: ambiguous
                out.pop(name, None)
            else:
                out[name] = node.value
    return out


class _ModuleScan:
    """Per-module context shared by the finding and census passes."""

    def __init__(self, graph: CallGraph, syms) -> None:
        self.graph = graph
        self.syms = syms
        self.consts = _module_str_consts(syms.module.tree)
        self.resolver = _Resolver(graph, syms)

    def type_of(self, node: ast.AST) -> str:
        s = astutil.const_str(node)
        if s is not None:
            return s
        if isinstance(node, ast.Name):
            if node.id in self.consts:
                return self.consts[node.id]
            # imported constant: alias -> defining module's table
            target = self.syms.aliases.get(node.id)
            if target:
                mod, _, leaf = target.rpartition(".")
                other = self.graph.module_by_dotted.get(mod)
                if other is not None:
                    consts = _module_str_consts(other.module.tree)
                    if leaf in consts:
                        return consts[leaf]
        return "<dynamic>"

    def unsafe_kind(self, v: ast.AST, cls: str | None,
                    local_values: dict) -> str | None:
        if isinstance(v, ast.Name) and v.id in local_values:
            v = local_values[v.id]
        if isinstance(v, ast.Await):
            return None                     # awaited: a plain result
        if isinstance(v, ast.Call):
            leaf = astutil.name_leaf(v.func)
            if leaf in _FUTURE_CALLS or leaf == "Future":
                return "an asyncio future/task"
            if leaf in _SYNC_PRIMITIVES:
                base = astutil.dotted(v.func) or ""
                head = self.syms.expand_alias(base.split(".", 1)[0])
                if head in ("asyncio", "threading", "") or "." not \
                        in base:
                    return "a synchronization primitive"
            d = astutil.dotted(v.func)
            if d and "." in d:
                head = self.syms.expand_alias(d.split(".", 1)[0])
                if head == "jax" or head.startswith("jax."):
                    return "a live jax Array"
                if head == "torch" or head.startswith("torch."):
                    return "a live torch tensor"
            for dst, fo in self.resolver.resolve_call(v, cls, []):
                if fo <= MAX_FANOUT:
                    fi = self.graph.functions.get(dst)
                    if fi is not None and fi.is_async:
                        return "an un-awaited coroutine"
        if isinstance(v, ast.Attribute) and isinstance(v.ctx,
                                                       ast.Load):
            base = v.value
            if (isinstance(base, ast.Name) and base.id == "self"
                    and cls is not None):
                ci = self.syms.classes.get(cls)
                if ci is not None and v.attr in ci.methods:
                    return "a bound method"
        return None


def _payload_fields(call: ast.Call,
                    local_values: dict) -> list[tuple[str, ast.AST]]:
    data = None
    if len(call.args) >= 2:
        data = call.args[1]
    else:
        for kw in call.keywords:
            if kw.arg == "data":
                data = kw.value
    if isinstance(data, ast.Name):
        data = local_values.get(data.id)
    if not isinstance(data, ast.Dict):
        return []
    out = []
    for k, v in zip(data.keys, data.values):
        ks = astutil.const_str(k) if k is not None else None
        if ks is not None:
            out.append((ks, v))
    return out


def _message_sites(graph: CallGraph):
    """Yield one record per ``Message(...)`` construction in the
    project."""
    for path in sorted(graph.symbols):
        syms = graph.symbols[path]
        scan = _ModuleScan(graph, syms)
        contexts = [(graph.module_root(path),
                     syms.module.tree, None)]
        contexts += [(fi.qualname, fi.node, fi.cls)
                     for fi in syms.functions]
        for qual, root, cls in contexts:
            local_values = _local_values(root)
            for node in own_nodes(root):
                if not (isinstance(node, ast.Call)
                        and astutil.name_leaf(node.func) == "Message"
                        and node.args):
                    continue
                mtype = scan.type_of(node.args[0])
                fields = _payload_fields(node, local_values)
                yield (scan, path, qual, cls, node, mtype, fields,
                       local_values)


def wire_codec_table(graph: CallGraph) -> dict[str, tuple[str, str]]:
    """The ``WIRE_CODECS`` dict literal, parsed: type -> (enc, dec)
    function leaf names (empty when the module is out of scope)."""
    out: dict[str, tuple[str, str]] = {}
    for syms in graph.symbols.values():
        for stmt in syms.module.tree.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "WIRE_CODECS"
                    and isinstance(stmt.value, ast.Dict)):
                continue
            for k, v in zip(stmt.value.keys, stmt.value.values):
                ks = astutil.const_str(k) if k is not None else None
                if ks is None or not isinstance(v, ast.Tuple) \
                        or len(v.elts) != 2:
                    continue
                enc = astutil.name_leaf(v.elts[0])
                dec = astutil.name_leaf(v.elts[1])
                if enc and dec:
                    out[ks] = (enc, dec)
    return out


def handled_types(graph: CallGraph) -> set[str]:
    """Message types some dispatcher consumes: a ``msg.type == "x"``
    / ``in ("x", ...)`` comparison, or a ``_h_<type>`` handler method
    (the ``getattr(self, f"_h_{msg.type}")`` dispatch idiom)."""
    out: set[str] = set()
    for fi in graph.functions.values():
        leaf = fi.local.rpartition(".")[2]
        if leaf.startswith("_h_"):
            out.add(leaf[len("_h_"):])
    for syms in graph.symbols.values():
        for node in ast.walk(syms.module.tree):
            if not isinstance(node, ast.Compare):
                continue
            left = node.left
            if not (isinstance(left, ast.Attribute)
                    and left.attr == "type"):
                continue
            for comp in node.comparators:
                s = astutil.const_str(comp)
                if s is not None:
                    out.add(s)
                elif isinstance(comp, (ast.Tuple, ast.Set,
                                       ast.List)):
                    for e in comp.elts:
                        es = astutil.const_str(e)
                        if es is not None:
                            out.add(es)
    return out


def _request_of(mtype: str) -> str | None:
    """The request type a conventional reply/ack name answers, or
    None when the name is not reply-shaped.  Replies are matched by
    per-request waiter queues (``msg.type == reply_type``), which no
    static dispatch table shows."""
    for suffix in ("_reply", "_ack"):
        if mtype.endswith(suffix):
            return mtype[:-len(suffix)]
    return None


def wire_census(graph: CallGraph) -> list[dict]:
    """One entry per constructed message type: codec verdict, the
    fields seen across all construction sites, whether the dispatch
    side handles it, and any unsafe fields."""
    codecs = wire_codec_table(graph)
    handled = handled_types(graph)
    types: dict[str, dict] = {}
    for scan, path, qual, cls, node, mtype, fields, local_values \
            in _message_sites(graph):
        entry = types.setdefault(mtype, {
            "type": mtype, "fields": set(), "sites": [],
            "unsafe_fields": []})
        entry["sites"].append(f"{path}:{node.lineno}")
        for k, v in fields:
            entry["fields"].add(k)
            kind = scan.unsafe_kind(v, cls, local_values)
            if kind is not None:
                entry["unsafe_fields"].append(
                    {"field": k, "carries": kind,
                     "site": f"{path}:{node.lineno}"})
    out = []
    for mtype in sorted(types):
        e = types[mtype]
        if mtype in codecs:
            codec = "typed"
        elif mtype.startswith("__"):
            codec = "control"
        elif mtype == "<dynamic>":
            codec = "dynamic"
        else:
            codec = "generic"
        verdict = ("unsafe" if e["unsafe_fields"] else "wire-safe")
        req = _request_of(mtype)
        consumed = (mtype in handled or codec in ("control", "dynamic")
                    or (req is not None
                        and (req in types or req in handled)))
        out.append({"type": mtype, "codec": codec,
                    "verdict": verdict,
                    "handled": consumed,
                    "fields": sorted(e["fields"]),
                    "sites": e["sites"],
                    "unsafe_fields": e["unsafe_fields"]})
    return out


@register
class WireSafety(ProjectChecker):
    name = "wire-safety"
    description = ("Message payload fields carrying futures, "
                   "coroutines, locks, live jax Arrays or torch "
                   "tensors, or bound "
                   "methods -- objects that cannot cross a process "
                   "transport; censuses the wire-type vocabulary "
                   "for --seam-report")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        orphans = {e["type"] for e in wire_census(graph)
                   if not e["handled"]}
        for scan, path, qual, cls, node, mtype, fields, \
                local_values in _message_sites(graph):
            for k, v in fields:
                kind = scan.unsafe_kind(v, cls, local_values)
                if kind is None:
                    continue
                yield Finding(
                    path, node.lineno, self.name,
                    f"message '{mtype}' payload field '{k}' "
                    f"carries {kind} -- it cannot cross a process "
                    f"transport; ship plain data and rebuild the "
                    f"object on the receiving side")
            if mtype in orphans:
                yield Finding(
                    path, node.lineno, self.name,
                    f"message type '{mtype}' is constructed but no "
                    f"dispatcher consumes it (no == comparison, no "
                    f"_h_{mtype} handler, no request counterpart for "
                    f"a reply queue) -- dead wire vocabulary, or a "
                    f"sender whose reply silently hangs")
