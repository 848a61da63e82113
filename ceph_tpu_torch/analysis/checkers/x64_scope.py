"""torch-global-state: no module flips torch's process-wide state at import.

Port of ``ceph_tpu/analysis/checkers/x64_scope.py``.  The reference's
rule guards ``jax_enable_x64``: one import that flips it changes dtype
semantics for every computation in the process.  torch has the same bug
class in its own switches: a module that, merely by being imported, sets
the default dtype or device, turns on TF32 or deterministic algorithms,
or reseeds the global generator changes what every other module computes
(or draws) -- and which module was imported first decides it.  The port
draws its random data from a ``torch.Generator`` of its own and sets no
switch at all; this rule keeps it so.

Flagged in code that runs at import (a module's top level and class
bodies, not function bodies and not an ``if __name__ == "__main__"``
block):

* a call of one of torch's process-wide setters (``_SETTERS``:
  ``torch.set_default_dtype``, ``torch.use_deterministic_algorithms``,
  ``torch.manual_seed``, ``torch.cuda.set_device`` ...);
* an assignment to an attribute under ``torch.backends`` (the
  ``torch.backends.cuda.matmul.allow_tf32 = True`` form).
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..core import Finding, Module
from ..project import ModuleSymbols
from ..registry import Checker, register
from .device_path import _imports_top

_SETTERS = {
    "torch.set_default_dtype", "torch.set_default_tensor_type",
    "torch.set_default_device", "torch.use_deterministic_algorithms",
    "torch.set_deterministic_debug_mode", "torch.manual_seed", "torch.seed",
    "torch.set_float32_matmul_precision", "torch.set_num_threads",
    "torch.set_num_interop_threads", "torch.set_flush_denormal",
    "torch.set_grad_enabled", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.set_device",
    "torch.cuda.set_per_process_memory_fraction",
}


def _import_time(tree: ast.Module) -> Iterable[ast.AST]:
    """Every node that runs when the module is imported."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            stack.extend(node.decorator_list
                         if not isinstance(node, ast.Lambda) else [])
            continue
        if isinstance(node, ast.If) and _is_main_guard(node.test):
            stack.extend(node.orelse)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_main_guard(test: ast.AST) -> bool:
    return (isinstance(test, ast.Compare) and len(test.comparators) == 1
            and astutil.dotted(test.left) == "__name__"
            and astutil.const_str(test.comparators[0]) == "__main__")


@register
class TorchGlobalState(Checker):
    name = "torch-global-state"
    description = ("torch's process-wide state (default dtype/device, "
                   "TF32, determinism, global seed) set at import")

    def check(self, module: Module) -> Iterable[Finding]:
        if not _imports_top(module.tree, "torch"):
            return
        syms = ModuleSymbols.collect(module)

        def full(node: ast.AST) -> str:
            """The dotted name through the import table (``t.cuda`` ->
            ``torch.cuda``)."""
            head, _, rest = (astutil.dotted(node) or "").partition(".")
            return syms.expand_alias(head) + ("." + rest if rest else "")

        for node in _import_time(module.tree):
            if isinstance(node, ast.Call) and full(node.func) in _SETTERS:
                yield Finding(
                    module.path, node.lineno, self.name,
                    f"{full(node.func)}() at import sets torch's "
                    f"process-wide state for every module of the "
                    f"process; set it where it is needed (a local "
                    f"torch.Generator, an explicit dtype/device)")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            full(t).startswith("torch.backends."):
                        yield Finding(
                            module.path, node.lineno, self.name,
                            f"assignment to {full(t)} at import flips a "
                            f"process-wide torch switch for every "
                            f"module of the process")
