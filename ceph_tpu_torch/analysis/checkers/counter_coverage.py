"""counter-coverage: every perf-counter touch needs a live path.

``perf-coherence`` checks counter keys are *shaped* consistently;
this rule checks they can *fire*.  A counter incremented only inside
a function no entry point reaches is dead instrumentation: the
dashboard charts it as eternally zero and an operator debugging from
it chases a path that cannot execute.  It usually means one of two
bugs -- the instrumented helper lost its last caller in a refactor
(the counter should go), or the wiring that was supposed to call the
helper was never written (the counter is a lie).

Liveness is over-approximated on purpose: entry points are module
top-level code plus every public-shaped function (no leading
underscore, dunders, ``test_*``, ``main``), and the closure follows
call edges at any fan-out *and* reference edges (handler tables,
callbacks, decorators), so only a private function that nothing
reachable even *mentions* is dead.  Tests drive the tree through its
public API, so "reachable from a public function" is the static
stand-in for "some test or daemon path exercises it".
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register
from .perf_coherence import _perfish

_MUTATORS = {"inc", "tinc", "set_gauge", "hist_sample", "time"}


@register
class CounterCoverage(ProjectChecker):
    name = "counter-coverage"
    description = ("perf counters touched only in functions no "
                   "entry point (public API, test, module top "
                   "level) reaches -- dead instrumentation")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        live = graph.reachable(graph.entry_points(), refs=True)
        for qual in sorted(graph.functions):
            if qual in live:
                continue
            fi = graph.functions[qual]
            for node in own_nodes(fi.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS
                        and _perfish(node.func.value)):
                    continue
                key = (astutil.const_str(node.args[0])
                       if node.args else None)
                what = (f"counter '{key}'" if key
                        else f".{node.func.attr}(...)")
                yield Finding(
                    fi.path, node.lineno, self.name,
                    f"{what} is touched only in '{fi.local}', which "
                    f"no entry point reaches (not called or "
                    f"referenced from any public function, test, or "
                    f"module top level) -- dead instrumentation: "
                    f"wire the caller or drop the counter")
                break       # one finding per dead function is enough
