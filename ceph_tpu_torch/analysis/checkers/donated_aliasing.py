"""donated-buffer-aliasing: no reads of a buffer a launch consumed.

Port of ``ceph_tpu/analysis/checkers/donated_aliasing.py``.  The
reference guards ``jax.jit(..., donate_argnums=...)``: XLA may alias a
donated buffer into the output or free it, so reading the Python name
again after the launch reads garbage.  torch has no donation, but the
port keeps the contract where the reference had it: ``MeshCodec`` with
``donate`` (the default) launches a batch that is already on the card as
it is, and its RMW XORs the new parity into the old-parity tensor IN
PLACE, so a tensor passed there is the launch's from then on -- reading
the name again reads the NEW parity, whatever the caller meant.

Detection is the reference's, without its jit half (no ``jax.jit``
binding exists to carry ``donate_argnums``):

* a *donating callable* is one of ``ROOTS``, by ``Class.method`` name,
  with the call-arg positions (after self) it consumes; a call reaches
  it through ``self``, an imported name, or a receiver named as the
  repo names its instances (``mesh`` / ``self._mesh`` for a
  ``MeshCodec``);
* donation PROPAGATES interprocedurally: a function that forwards its
  own parameter into a donated position is itself donating that
  parameter (fixpoint over the project), so a caller module away from
  the launch still gets flagged;
* at every call site of a donating callable, an argument spelled as a
  plain name that is READ again after the call -- before any re-binding
  of the name -- is a finding.

Scoped to torch-importing modules: nothing else produces these buffers.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register
from .device_path import _imports_top

# the launches that consume a tensor argument, with the call-arg indices
# (after self) they consume: MeshCodec's RMW updates the old parity in
# place
ROOTS = (
    ("MeshCodec.rmw", (1,)),
)


def _params(node) -> list[str]:
    a = node.args
    return [p.arg for p in (a.posonlyargs + a.args)]


@register
class DonatedBufferAliasing(ProjectChecker):
    name = "donated-buffer-aliasing"
    description = ("a tensor read after being passed into a launch "
                   "position that consumes it (MeshCodec's in-place RMW) "
                   "-- reading it back is use-after-donate")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        in_scope = {
            path for path, syms in graph.symbols.items()
            if _imports_top(syms.module.tree, "torch")}
        if not in_scope:
            return
        # donors: qualname -> donated CALL-ARG positions
        donors: dict[str, tuple[int, ...]] = {}
        for spec, pos in ROOTS:
            for qual in graph.lookup(spec):
                fi = graph.functions.get(qual)
                if fi is not None and fi.path in in_scope:
                    donors[qual] = tuple(sorted(set(donors.get(qual, ()))
                                                | set(pos)))

        # interprocedural fixpoint: forwarding a parameter into a
        # donated position makes the forwarder a donor of that param
        for _ in range(6):
            grew = False
            for path in in_scope:
                syms = graph.symbols[path]
                for fi in syms.functions:
                    params = _params(fi.node)
                    off = 1 if fi.cls and params[:1] == ["self"] else 0
                    mine: set[int] = set(donors.get(fi.qualname, ()))
                    before = len(mine)
                    for call, pos in self._donating_calls(
                            fi, syms, graph, donors):
                        for p in pos:
                            if p >= len(call.args):
                                continue
                            arg = call.args[p]
                            if isinstance(arg, ast.Name) \
                                    and arg.id in params:
                                cp = params.index(arg.id) - off
                                if cp >= 0:
                                    mine.add(cp)
                    if len(mine) > before:
                        donors[fi.qualname] = tuple(sorted(mine))
                        grew = True
            if not grew:
                break

        for path in sorted(in_scope):
            syms = graph.symbols[path]
            for fi in syms.functions:
                yield from self._check_function(fi, syms, graph,
                                                donors)

    def _donating_calls(self, fi, syms, graph: CallGraph, donors: dict):
        """(call node, donated call-arg positions) sites in ``fi``."""
        for node in own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            pos = self._resolve_donor(node, fi, syms, graph, donors)
            if pos:
                yield node, pos

    @staticmethod
    def _resolve_donor(call: ast.Call, fi, syms, graph: CallGraph,
                       donors: dict):
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            tf = syms.top_funcs.get(name)
            if tf is not None:
                return donors.get(tf.qualname)
            target = syms.aliases.get(name)
            if target and "." in target:
                mod, _, leaf = target.rpartition(".")
                msyms = graph.module_by_dotted.get(mod)
                if msyms is not None:
                    tf = msyms.top_funcs.get(leaf)
                    if tf is not None:
                        return donors.get(tf.qualname)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        if fi.cls and isinstance(func.value, ast.Name) \
                and func.value.id == "self":
            ci = syms.classes.get(fi.cls)
            if ci is not None:
                meth = ci.methods.get(func.attr)
                if meth is not None:
                    return donors.get(meth.qualname)
            return None
        # a call on another receiver (``mesh.rmw(...)``,
        # ``self._mesh.rmw(...)``): typed by the repo's naming convention,
        # a receiver whose name opens its class's (``mesh`` -> MeshCodec)
        leaf = (astutil.name_leaf(func.value) or "").strip("_").lower()
        if not leaf:
            return None
        for q, pos in donors.items():
            fi2 = graph.functions.get(q)
            if fi2 is not None and fi2.cls and fi2.name == func.attr \
                    and fi2.cls.lower().startswith(leaf):
                return pos
        return None

    def _check_function(self, fi, syms, graph: CallGraph,
                        donors: dict) -> Iterable[Finding]:
        sites = list(self._donating_calls(fi, syms, graph, donors))
        if not sites:
            return
        # name -> [load linenos], [store linenos]
        loads: dict[str, list[int]] = {}
        stores: dict[str, list[int]] = {}
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node.lineno)
                else:
                    stores.setdefault(node.id, []).append(node.lineno)
        for call, pos in sites:
            end = getattr(call, "end_lineno", call.lineno)
            for p in pos:
                if p >= len(call.args):
                    continue
                arg = call.args[p]
                if not isinstance(arg, ast.Name):
                    continue
                name = arg.id
                rebinds = [ln for ln in stores.get(name, ())
                           if ln >= call.lineno]
                horizon = min(rebinds) if rebinds else 10 ** 9
                bad = [ln for ln in loads.get(name, ())
                       if end < ln < horizon]
                if bad:
                    yield Finding(
                        fi.path, min(bad), self.name,
                        f"`{name}` read after the launch at line "
                        f"{call.lineno} consumed it (donated arg "
                        f"position {p}): the launch owns a donated "
                        f"buffer -- read before the launch, re-bind "
                        f"the name, or copy first")
