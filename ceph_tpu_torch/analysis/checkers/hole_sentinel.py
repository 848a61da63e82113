"""hole-sentinel: raw CRUSH holes must be normalized before role math.

The wedge this guards: raw CRUSH output encodes holes as ``CRUSH_ITEM_NONE``
(2^31-1), which passes every ``o >= 0`` "is this a live osd" test and
left hole-led PGs primary-less.  The contract since then: holes are
normalized to ``-1`` at the map boundary (``pg_to_up_acting``), and
everything downstream uses ``o >= 0``.

This rule patrols the boundary.  In any module that can observe *raw*
CRUSH output (it imports the mapper / vectorized engine or handles
``CRUSH_ITEM_NONE`` itself -- excluding the ``crush/`` layer, which IS
the raw producer), an osd-id comparison against 0 or -1, or an osd-id
truthiness test, is flagged unless the enclosing function demonstrates
sentinel awareness by referencing ``CRUSH_ITEM_NONE`` somewhere in its
body (the guard-and-filter idiom the boundary uses).
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..core import Finding, Module
from ..registry import Checker, register

SENTINEL = "CRUSH_ITEM_NONE"
_RAW_IMPORTS = ("crush.mapper", "crush.vectorized")
# identifiers treated as osd ids when compared (exact, or any name
# containing "osd"): the vocabulary the placement pipeline actually
# uses for device ids
_OSD_NAMES = {"o", "osd", "cand", "primary"}


def _is_osdish(node: ast.AST) -> bool:
    leaf = astutil.name_leaf(node)
    if leaf is None:
        return False
    low = leaf.lower()
    # plural identifiers (osds, new_up_osds, osd_ids) are collections
    # of ids, not ids: truthiness/compares on them are emptiness
    # tests, not the hole-sentinel bug class
    if low.endswith("s"):
        return False
    return leaf in _OSD_NAMES or "osd" in low


def _aware(fn: ast.AST | None, module: Module) -> bool:
    """Sentinel awareness: the innermost enclosing function (or the
    whole module, for top-level code) references CRUSH_ITEM_NONE."""
    scope = fn if fn is not None else module.tree
    return astutil.references_name(scope, SENTINEL)


@register
class HoleSentinel(Checker):
    name = "hole-sentinel"
    description = ("osd-id compares vs 0/-1 in raw-CRUSH-observing "
                   "modules must handle CRUSH_ITEM_NONE")

    def scope(self, module: Module) -> bool:
        if "crush/" in module.path or "/crush/" in module.path:
            return False           # the raw layer itself
        tree = module.tree
        return (astutil.references_name(tree, SENTINEL)
                or astutil.imports_module(tree, *_RAW_IMPORTS))

    def check(self, module: Module) -> Iterable[Finding]:
        astutil.attach_parents(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Compare):
                yield from self._check_compare(node, module)
            elif isinstance(node, (ast.If, ast.IfExp, ast.While)):
                yield from self._check_truthiness(node, module)

    def _check_compare(self, node: ast.Compare,
                       module: Module) -> Iterable[Finding]:
        operands = [node.left] + list(node.comparators)
        ops = node.ops
        hit = None
        for i, op in enumerate(ops):
            left, right = operands[i], operands[i + 1]
            for name_side, const_side in ((left, right), (right, left)):
                if not _is_osdish(name_side):
                    continue
                val = astutil.int_value(const_side)
                if val == 0 and isinstance(op, (ast.GtE, ast.Lt,
                                                ast.LtE, ast.Gt)):
                    hit = f"{astutil.name_leaf(name_side)} vs 0"
                elif val == -1 and isinstance(op, (ast.Eq, ast.NotEq)):
                    hit = f"{astutil.name_leaf(name_side)} vs -1"
        if hit is None:
            return
        fn = astutil.enclosing_function(node)
        if _aware(fn, module):
            return
        yield Finding(
            module.path, node.lineno, self.name,
            f"osd-id comparison ({hit}) in a raw-CRUSH-observing "
            f"module without a {SENTINEL} guard in the enclosing "
            f"function; normalize holes to -1 first "
            f"(pg_to_up_acting boundary)")

    def _check_truthiness(self, node: ast.AST,
                          module: Module) -> Iterable[Finding]:
        test = node.test
        if not (isinstance(test, (ast.Name, ast.Attribute))
                and _is_osdish(test)):
            return
        fn = astutil.enclosing_function(node)
        if _aware(fn, module):
            return
        yield Finding(
            module.path, node.lineno, self.name,
            f"truthiness test on osd id "
            f"`{astutil.name_leaf(test)}` in a raw-CRUSH-observing "
            f"module: {SENTINEL} (2^31-1) and osd.0 both defeat it; "
            f"compare against the normalized -1 hole instead")
