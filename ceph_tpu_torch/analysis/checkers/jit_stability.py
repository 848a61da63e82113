"""kernel-build-once: a kernel library is built and loaded once.

Port of ``ceph_tpu/analysis/checkers/jit_stability.py``.  The reference's
rule keeps ``jax.jit`` callables from being rebuilt (a fresh callable per
call or per loop iteration misses the compile cache and recompiles).  The
port's kernels are CUDA sources that ``ops/_build.py`` compiles with nvcc
and ``ctypes`` loads: the same hazard is a library compiled, registered
or loaded again per call -- an nvcc run or a ``dlopen`` plus the typing
of every C entry, on a path that launches once per batch.  The sanctioned
shape is the memoized loader: ``@functools.lru_cache`` on ``_lib()``
(``ops/gf2kernels.py``), or a ``dict`` / ``None`` memo tested before the
load (``ops/_build.py::library``, ``native.py::load``).

The build and load calls (``_action``) are ``ctypes.CDLL``,
``_build.build`` and ``_build.add_generated``, torch's
``cpp_extension.load`` / ``load_inline``, and a module's own ``_load``.
One is flagged

* inside a loop or comprehension of its function: a build or load per
  iteration (``add_generated`` only registers source text, so a loop of
  them followed by one ``build`` is the sanctioned shape);
* in a function reachable from a launch entry point (the
  device-path-host-sync rule's ``ROOTS``, through call edges of fan-out
  <= ``MAX_FANOUT`` that stay in torch modules and do not enter a cached
  function), unless the function is cached or the call sits under a memo
  test (``if x is None``, ``if not x``, ``if k not in d``): a build or
  load per launch.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register
from .device_path import MAX_FANOUT, ROOTS, _imports_top

_CACHES = {"lru_cache", "cache", "cached_property"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _action(node: ast.Call, syms) -> str | None:
    """The build or load a call is, or None."""
    name = astutil.dotted(node.func) or ""
    head, _, rest = name.partition(".")
    full = syms.expand_alias(head) + ("." + rest if rest else "")
    leaf = name.rsplit(".", 1)[-1]
    if full in ("ctypes.CDLL", "ctypes.cdll.LoadLibrary"):
        return "ctypes.CDLL" if leaf == "CDLL" else full
    if leaf in ("build", "add_generated") and "." in name:
        base = full.rsplit(".", 1)[0]
        if base.rsplit(".", 1)[-1] == "_build":
            return f"_build.{leaf}"
    if leaf in ("load", "load_inline") and \
            full.startswith("torch.utils.cpp_extension"):
        return f"cpp_extension.{leaf}"
    if name == "_load":
        return "_load"
    return None


def _cached(fn: ast.AST) -> bool:
    return any(n.rsplit(".", 1)[-1] in _CACHES
               for n in astutil.decorator_names(fn))


def _memo_test(test: ast.AST) -> bool:
    """``x is None``, ``not x``, ``k not in d``: a test that a memo is
    empty."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return True
    if isinstance(test, ast.BoolOp):
        return any(_memo_test(v) for v in test.values)
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and (isinstance(test.ops[0], ast.NotIn)
                 or (isinstance(test.ops[0], ast.Is)
                     and isinstance(test.comparators[0], ast.Constant)
                     and test.comparators[0].value is None)))


@register
class KernelBuildOnce(ProjectChecker):
    name = "kernel-build-once"
    description = ("kernel library built or loaded inside a loop, or per "
                   "launch on a path without a cache or memo")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        per_launch = self._per_launch(graph)
        parented: set[str] = set()
        for qual, fi in sorted(graph.functions.items()):
            syms = graph.symbols[fi.path]
            for node in own_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                what = _action(node, syms)
                if what is None:
                    continue
                if fi.path not in parented:
                    astutil.attach_parents(syms.module.tree)
                    parented.add(fi.path)
                if what != "_build.add_generated" and \
                        self._in_loop(node, fi.node):
                    yield Finding(
                        fi.path, node.lineno, self.name,
                        f"{what}() inside a loop: a build or load per "
                        f"iteration; build every source in one "
                        f"_build.build call and load each library once")
                elif qual in per_launch and not _cached(fi.node) \
                        and not self._memo_guarded(node, fi.node):
                    yield Finding(
                        fi.path, node.lineno, self.name,
                        f"{what}() on a launch path (reachable from "
                        f"{per_launch[qual]}) with no cache or memo: a "
                        f"build or load per launch; load through a "
                        f"@functools.lru_cache'd _lib()")

    @staticmethod
    def _per_launch(graph: CallGraph) -> dict[str, str]:
        """Functions reachable from the launch roots without entering a
        cached function, each with the root it is reached from."""
        in_scope = {path for path, syms in graph.symbols.items()
                    if _imports_top(syms.module.tree, "torch")}
        stack = [(q, spec) for spec in ROOTS for q in graph.lookup(spec)
                 if graph.functions[q].path in in_scope]
        seen: dict[str, str] = {}
        while stack:
            cur, origin = stack.pop()
            if cur in seen:
                continue
            seen[cur] = origin
            for dst, fo in graph.calls.get(cur, {}).items():
                fi = graph.functions.get(dst)
                if (fo <= MAX_FANOUT and dst not in seen and fi is not None
                        and fi.path in in_scope and not _cached(fi.node)):
                    stack.append((dst, origin))
        return seen

    @staticmethod
    def _in_loop(node: ast.AST, fn: ast.AST) -> bool:
        for anc in astutil.ancestors(node):
            if anc is fn:
                return False
            if isinstance(anc, _LOOPS):
                return True
        return False

    @staticmethod
    def _memo_guarded(node: ast.AST, fn: ast.AST) -> bool:
        for anc in astutil.ancestors(node):
            if anc is fn:
                return False
            if isinstance(anc, ast.If) and _memo_test(anc.test):
                return True
        return False
