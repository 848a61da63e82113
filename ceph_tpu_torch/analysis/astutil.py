"""Small AST helpers shared by the checkers.

Everything here works on structure, never on raw source text: a rule
that grepped for ``"CRUSH_ITEM_NONE"`` would fire on its own
implementation (and on docstrings), while an ``ast.Name`` test cannot.
"""

from __future__ import annotations

import ast
from typing import Iterator

PARENT_ATTR = "_lint_parent"


def attach_parents(tree: ast.AST) -> ast.AST:
    """Stamp every node with a ``_lint_parent`` backlink (idempotent)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, PARENT_ATTR, node)
    return tree


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, PARENT_ATTR, None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_function(node: ast.AST) -> ast.AST | None:
    """Innermost (Async)FunctionDef containing `node`, if any."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def name_leaf(node: ast.AST) -> str | None:
    """The final identifier of a Name or Attribute (``a.b.c`` -> c)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def int_value(node: ast.AST) -> int | None:
    """Evaluate an int literal, including unary minus (``-1``)."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, ast.USub)):
        inner = int_value(node.operand)
        return -inner if inner is not None else None
    return None


def names_in(node: ast.AST) -> set[str]:
    """All bare Name identifiers inside a subtree."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def references_name(tree: ast.AST, ident: str) -> bool:
    """True if `ident` appears as a Name or Attribute leaf (not as a
    string constant) anywhere in the subtree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == ident:
            return True
        if isinstance(node, ast.Attribute) and node.attr == ident:
            return True
    return False


def imports_module(tree: ast.AST, *suffixes: str) -> bool:
    """True if the module imports any dotted path ending in one of
    `suffixes` (handles absolute and relative imports)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = [mod] + [f"{mod}.{a.name}" if mod else a.name
                             for a in node.names]
        else:
            continue
        for name in names:
            for suf in suffixes:
                if name == suf or name.endswith("." + suf):
                    return True
    return False


def decorator_names(fn: ast.AST) -> list[str]:
    """Dotted names of each decorator; for ``partial(f, ...)`` style
    decorators the *call target* name is returned (``partial``)."""
    out = []
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted(target)
        if name:
            out.append(name)
    return out
