"""perf-coherence: counter keys must be used consistently tree-wide.

``PerfCounters`` auto-vivifies plain counters, so the failure modes
are not missing registrations but *shape* mismatches that only bite
at scrape time -- this is the cross-module, two-pass rule:

* ``hist_sample(key)`` with no ``hist_register(key)`` anywhere in the
  tree is a guaranteed ``KeyError`` the first time the code path runs
  (the register lives in one module, the sample sites in others);
* ``hist_register(key)`` that nothing ever samples is a dead counter
  the dashboards will chart as eternally zero;
* one key used as two different kinds (``inc`` + ``set_gauge``,
  ``inc`` + ``tinc``, ...) collides in ``dump()``'s flat namespace --
  the gauge/avg silently overwrites the counter in the scraped JSON.

Pass 1 (``check``) collects constant-string keys invoked on
perf-shaped receivers (``perf``, ``pc``, ``*perf*``); pass 2
(``finalize``) reconciles them across every module.  Dynamic
(non-literal) keys are out of scope by design.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..core import Finding, Module, Project
from ..registry import Checker, register

_METHOD_KIND = {
    "inc": "counter",
    "get": "counter",
    "set_gauge": "gauge",
    "tinc": "avg",
    "time": "avg",
    "hist_sample": "hist_sample",
    "hist_register": "hist_register",
}
# kinds that land in dump()'s flat key namespace and therefore collide
_VALUE_KINDS = ("counter", "gauge", "avg", "hist_register")


def _perfish(receiver: ast.AST) -> bool:
    leaf = astutil.name_leaf(receiver)
    if leaf is None:
        return False
    return leaf in ("pc",) or "perf" in leaf.lower()


@register
class PerfCoherence(Checker):
    name = "perf-coherence"
    description = ("perf counter keys sampled-but-unregistered, "
                   "registered-but-untouched, or kind-colliding "
                   "across modules")

    def __init__(self) -> None:
        # key -> kind -> first (path, line) observed
        self._sites: dict[str, dict[str, tuple[str, int]]] = {}

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            kind = _METHOD_KIND.get(node.func.attr)
            if kind is None or not node.args:
                continue
            if not _perfish(node.func.value):
                continue
            key = astutil.const_str(node.args[0])
            if key is None:
                continue
            self._sites.setdefault(key, {}).setdefault(
                kind, (module.path, node.lineno))
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        sites, self._sites = self._sites, {}
        for key in sorted(sites):
            kinds = sites[key]
            if "hist_sample" in kinds and "hist_register" not in kinds:
                path, line = kinds["hist_sample"]
                yield Finding(
                    path, line, self.name,
                    f"histogram key '{key}' is sampled but never "
                    f"hist_register()ed anywhere in the tree: "
                    f"KeyError on first sample")
            if "hist_register" in kinds and "hist_sample" not in kinds:
                path, line = kinds["hist_register"]
                yield Finding(
                    path, line, self.name,
                    f"histogram key '{key}' is registered but never "
                    f"sampled anywhere in the tree: dead counter")
            value_kinds = [k for k in _VALUE_KINDS if k in kinds]
            if len(value_kinds) > 1:
                path, line = kinds[value_kinds[1]]
                yield Finding(
                    path, line, self.name,
                    f"key '{key}' is used as {value_kinds[0]} and as "
                    f"{value_kinds[1]}: the kinds share dump()'s "
                    f"flat namespace, one silently overwrites the "
                    f"other in the scraped JSON")
