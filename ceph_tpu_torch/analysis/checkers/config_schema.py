"""config-schema: every config key read must be declared somewhere.

``ConfigProxy`` raises on unknown options, but the daemons' hot paths
read plain dicts (``self.config.get("osd_...", default)``) which
auto-absolve typos: a misspelled key silently returns the inline
default forever, and a knob added in one module but never declared in
``DEFAULT_SCHEMA`` (or a daemon's defaults dict) can never be set via
``config set`` / central config push -- it looks tunable and is not.

Declarations, collected tree-wide (two-pass, like perf-coherence):

* ``Option("name", ...)`` constructor calls (the typed schema);
* string keys of dict literals assigned to a ``config``-named target
  (the per-daemon defaults tables: ``self.config = {...}``);
* the live ``ceph_tpu_torch.common.config.DEFAULT_SCHEMA``, when
  importable, so partial-tree runs (``lint --changed`` on one dirty
  file) don't false-positive on keys declared in an un-linted module.

Reads: ``X.get("some_key")`` / ``X["some_key"]`` (Load context) where
the receiver's leaf name is ``conf``/``config``/``cfg`` and the key
looks like an option name (snake_case with at least one underscore --
single words like ``events`` on unrelated dicts that happen to be
called ``config`` are out of scope by design).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .. import astutil
from ..core import Finding, Module, Project
from ..registry import Checker, register

_RECEIVERS = {"conf", "config", "cfg"}
_KEY_RE = re.compile(r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)+$")


def _schema_keys() -> set[str]:
    """Names declared by the live typed schema, best-effort."""
    try:
        from ...common.config import DEFAULT_SCHEMA
    except Exception:
        return set()
    return {o.name for o in DEFAULT_SCHEMA}


def _config_target(targets: list[ast.AST]) -> bool:
    """Is any assignment target a config defaults table by name?"""
    for t in targets:
        leaf = astutil.name_leaf(t)
        if leaf is not None and "config" in leaf.lower():
            return True
    return False


@register
class ConfigSchema(Checker):
    name = "config-schema"
    description = ("config keys read via conf/config get()/[] that "
                   "no Option() schema or defaults table declares")

    def __init__(self) -> None:
        self._declared: set[str] = set()
        # key -> list of (path, line) read sites
        self._reads: dict[str, list[tuple[str, int]]] = {}

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            # declarations: Option("name", ...)
            if isinstance(node, ast.Call) \
                    and astutil.name_leaf(node.func) == "Option" \
                    and node.args:
                key = astutil.const_str(node.args[0])
                if key is not None:
                    self._declared.add(key)
            # declarations: <...config...> = {"key": default, ...}
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Dict) \
                    and _config_target(node.targets):
                for k in node.value.keys:
                    if k is None:          # **spread entry
                        continue
                    key = astutil.const_str(k)
                    if key is not None:
                        self._declared.add(key)
            # reads: conf.get("key"[, default])
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and node.args:
                if astutil.name_leaf(node.func.value) in _RECEIVERS:
                    self._note_read(module, node, node.args[0])
            # reads: conf["key"] in Load context
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and astutil.name_leaf(node.value) in _RECEIVERS:
                self._note_read(module, node, node.slice)
        return ()

    def _note_read(self, module: Module, node: ast.AST,
                   key_node: ast.AST) -> None:
        key = astutil.const_str(key_node)
        if key is not None and _KEY_RE.match(key):
            self._reads.setdefault(key, []).append(
                (module.path, node.lineno))

    def finalize(self, project: Project) -> Iterable[Finding]:
        declared, self._declared = self._declared, set()
        reads, self._reads = self._reads, {}
        declared |= _schema_keys()
        for key in sorted(reads):
            if key in declared:
                continue
            for path, line in reads[key]:
                yield Finding(
                    path, line, self.name,
                    f"config key '{key}' is read here but no "
                    f"Option() schema entry or config defaults "
                    f"table declares it: typos read as the inline "
                    f"default forever and the knob cannot be set at "
                    f"runtime")
