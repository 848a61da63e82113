"""Whole-program symbol model: every module's functions, classes, and
import aliases, resolved once and shared by the interprocedural rules.

The per-module layer (``core.Module``) deliberately sees one
``ast.Module`` at a time; this layer stitches those trees into a
project-wide symbol table that ``callgraph.CallGraph`` turns into call
edges.  Resolution is *best effort by construction*: Python has no
sound static call graph, so the contract here is the one the checkers
need -- precise edges where the syntax supports them (local defs,
``self.method`` in a known class, imported names, dotted module
calls), name-based fuzzy edges everywhere else, each tagged with its
fan-out so a rule can choose how much ambiguity to traverse.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Module, Project


@dataclass
class FunctionInfo:
    """One function/method/nested def anywhere in the project."""

    qualname: str            # "<display path>::<local dotted name>"
    name: str                # bare name
    local: str               # "Class.method", "func", "f.<locals>.g"
    path: str                # module display path
    node: ast.AST            # the (Async)FunctionDef
    cls: str | None          # enclosing class name, if a method
    is_async: bool
    lineno: int


@dataclass
class ClassInfo:
    name: str
    bases: list[str]                       # dotted base-class names
    methods: dict[str, FunctionInfo] = field(default_factory=dict)


@dataclass
class ModuleSymbols:
    """Symbols and import aliases of one parsed module."""

    module: Module
    dotted: str                            # "ceph_tpu_torch.osd.backend"
    package: str                           # "ceph_tpu_torch.osd"
    functions: list[FunctionInfo] = field(default_factory=list)
    top_funcs: dict[str, FunctionInfo] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    # local alias -> dotted target ("np" -> "numpy",
    # "CodecBatcher" -> "ceph_tpu_torch.osd.codec_batcher.CodecBatcher")
    aliases: dict[str, str] = field(default_factory=dict)

    @classmethod
    def collect(cls, module: Module) -> "ModuleSymbols":
        dotted = path_to_dotted(module.path)
        package = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        if module.path.endswith("/__init__.py"):
            package = dotted
        syms = cls(module=module, dotted=dotted, package=package)
        _Collector(syms).visit(module.tree)
        return syms

    def expand_alias(self, name: str) -> str:
        """Map a local head identifier through the import table
        (``np`` -> ``numpy``); unknown names map to themselves."""
        return self.aliases.get(name, name)


def path_to_dotted(display: str) -> str:
    p = display[:-3] if display.endswith(".py") else display
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class _Collector(ast.NodeVisitor):
    """One pass over a module tree building its ModuleSymbols."""

    def __init__(self, syms: ModuleSymbols) -> None:
        self.syms = syms
        self._class_stack: list[str] = []
        self._func_stack: list[str] = []

    # -- imports -------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname:
                self.syms.aliases[a.asname] = a.name
            else:
                # `import a.b.c` binds `a`; dotted call resolution
                # re-joins the tail, so aliasing the head is enough
                head = a.name.split(".", 1)[0]
                self.syms.aliases.setdefault(head, head)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = self._resolve_from(node)
        for a in node.names:
            if a.name == "*":
                continue
            target = f"{base}.{a.name}" if base else a.name
            self.syms.aliases[a.asname or a.name] = target

    def _resolve_from(self, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        # relative import: anchor at this module's package
        parts = self.syms.package.split(".") if self.syms.package else []
        if node.level > 1:
            parts = parts[: len(parts) - (node.level - 1)]
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts)

    # -- defs ----------------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            d = _dotted(b)
            if d:
                bases.append(d)
        if not self._class_stack and not self._func_stack:
            self.syms.classes[node.name] = ClassInfo(node.name, bases)
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._add_function(node, is_async=False)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._add_function(node, is_async=True)

    def _add_function(self, node, is_async: bool) -> None:
        if self._func_stack:
            local = (".".join(self._func_stack)
                     + f".<locals>.{node.name}")
            cls = None
        elif self._class_stack:
            local = ".".join(self._class_stack) + f".{node.name}"
            cls = self._class_stack[-1]
        else:
            local = node.name
            cls = None
        info = FunctionInfo(
            qualname=f"{self.syms.module.path}::{local}",
            name=node.name, local=local, path=self.syms.module.path,
            node=node, cls=cls, is_async=is_async, lineno=node.lineno)
        self.syms.functions.append(info)
        if cls is not None:
            ci = self.syms.classes.get(cls)
            if ci is not None:
                ci.methods[node.name] = info
        elif not self._func_stack and not self._class_stack:
            self.syms.top_funcs[node.name] = info
        self._func_stack.append(node.name)
        # class scope does not leak into nested defs
        saved, self._class_stack = self._class_stack, []
        self.generic_visit(node)
        self._class_stack = saved
        self._func_stack.pop()


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def collect_symbols(project: Project) -> dict[str, ModuleSymbols]:
    """Symbol tables for every module, keyed by display path."""
    return {m.path: ModuleSymbols.collect(m) for m in project.modules}
