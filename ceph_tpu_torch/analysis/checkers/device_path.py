"""device-path-host-sync: no host syncs reachable from batch launches.

The batched data plane only pays off if a batch stays on the card from
launch to fan-out: one stray ``.cpu()`` / ``.item()`` / ``.tolist()`` /
``torch.cuda.synchronize()`` inside the launch closure blocks the host on
the card and re-serializes the whole batch through it, silently turning
the amortized round trip back into a per-op one.  This rule is the static
closure of that invariant: starting from the launch entry points (the
submit API of ``CodecBatcher`` and its staged launch spine, the batched
``StripeInfo`` entry points riding it, ``MeshCodec`` and the sharded codec, the
GF(2) wrappers, the bulk CRUSH mappers ``VectorCrush`` / ``RuleLanes`` /
``bulk_crush``, and the ``crc32c_batch`` engines), every function
reachable through call edges of fan-out <= 4 is "on the batched device
path", and host-sync operations there are findings.

Port of ``ceph_tpu/analysis/checkers/device_path.py`` for torch.  What
syncs is torch's:

* ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``, and ``.to()`` onto
  the CPU (``.to("cpu")``, ``.to(device="cpu")``,
  ``.to(torch.device("cpu"))``);
* ``.synchronize()``: ``torch.cuda.synchronize()``, an event's, a stream's;
* ``np.asarray`` / ``np.array`` of a name bound to a tensor in the same
  function (a parameter annotated ``torch.Tensor``, a ``torch.*`` result,
  or a tensor's method result, index or arithmetic).

A numpy array is a host array: ``np.asarray`` of one costs nothing, and
``.item()`` / ``.tolist()`` on a name bound to one (or on a numpy
expression) is not a finding.  Nor is ``.numpy()`` of a ``.cpu()``
result (the ``.cpu()`` is the sync), nor a read in the branch where a
test just said the data is on the CPU (``if xs.device.type == "cpu":``,
where a wrapper takes its plain version).

Two precision fences keep the closure on the data plane it guards, as in
the reference:

* the traversal never leaves *device-plane modules* (modules that import
  torch) -- a call that escapes into the transaction/messaging layers has
  already crossed the one intended host boundary, and everything past it
  is host code by construction;
* a fuzzy call edge of fan-out above ``MAX_FANOUT`` is not followed.

Deliberate host hops (the single post-launch materialization, the host
fallback for the CPU, the host CRC engine) carry a
``# lint: disable=device-path-host-sync`` with a one-line justification --
the suppression is the documentation that the hop was a decision, not an
accident.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, own_nodes
from ..core import Finding
from ..registry import ProjectChecker, register

# the launch entry points of the batched data plane, by Class.method (or
# bare function) name: the reference's roots under the port's names, then
# the port's own launch wrappers
ROOTS = (
    "CodecBatcher.encode",
    "CodecBatcher.decode",
    "MeshCodec.encode",
    "MeshCodec.decode",
    "MeshCodec.rmw",
    "StripeInfo.encode_async",
    "StripeInfo.decode_async",
    "StripeInfo.reconstruct_logical_async",
    "VectorCrush.map_pgs",
    "crc32c_batch",
    "crc32c_rows",
    "crc32c_device_chunks",
    "ErasureCodeCuda.encode_batch_crc",
    "TorchBackend.matmul_batch_crc",
    # the XOR-schedule launch entry points (ops/xor_schedule.py): the
    # batched scheduled kernel family and the host scheduled executor
    "sched_matmul_batch_device",
    "scheduled_xor_matmul",
    # the hedged gather spine (osd/hedged_gather.py): reply buffers flow
    # straight into decode launches
    "HedgedGather.gather_shards",
    "HedgedGather.first_reply",
    # the pipelined launch spine: its staged launches own the
    # dispatch/materialize split -- a stray host sync inside it would
    # close the overlap window the double-buffering opens
    "CodecBatcher._drive",
    "CodecBatcher._dispatch",
    "CodecBatcher._complete",
    # the flat linear codec family (ec/linear_codec.py): lrc/pmsr
    # encode/decode ride the batched kernels through these
    "LinearSubchunkCodec.encode_batch",
    "LinearSubchunkCodec.decode_batch",
    "LinearSubchunkCodec._batch_matmul",
    # the port's own: the mesh codec's one launch path, the GF(2) kernel
    # wrappers (K1/K2/K3), K4's device entries, the bulk CRUSH mappers
    # (K5 and K6) and the sharded codec's step
    "MeshCodec._apply",
    "gf_matmul_batch_device",
    "gf_matmul_device",
    "crc32c_chunks",
    "crc32c_chunks_pair",
    "VectorCrush.map_device",
    "RuleLanes.map_device",
    "bulk_crush",
    "bulk_crush_rows",
    "card_rows",
    "sharded_ec_step",
)

# ambiguity budget: a fuzzy call edge that could hit more than this many
# same-named functions is noise, not the device path
MAX_FANOUT = 4

_NUMPY_SYNCS = {"asarray", "array"}
# methods that move a tensor's data to the host (and wait for the card)
_METHOD_SYNCS = {"cpu", "numpy", "item", "tolist"}
# methods of a tensor whose result is not a tensor on the tensor's device
_HOST_RESULTS = _METHOD_SYNCS | {
    "to", "data_ptr", "dim", "size", "numel", "element_size", "stride",
    "is_contiguous", "storage_offset", "nbytes", "get_device"}
# torch.<name>(...) calls that make no tensor
_TORCH_NON_TENSORS = {"device", "Generator", "dtype", "Size", "is_tensor",
                      "get_default_dtype", "manual_seed", "no_grad",
                      "inference_mode", "set_grad_enabled"}


def _imports_top(tree: ast.AST, *tops: str) -> bool:
    """True if the module imports any of the given top-level packages
    (``import torch.nn`` and ``from torch import nn`` both count as
    ``torch``)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            heads = [a.name.split(".", 1)[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            heads = [(node.module or "").split(".", 1)[0]]
        else:
            continue
        if any(h in tops for h in heads):
            return True
    return False


def _head(node: ast.AST, syms) -> str:
    """The import target of an expression's dotted head (``np`` ->
    ``numpy``), or ""."""
    d = astutil.dotted(node)
    return syms.expand_alias(d.split(".", 1)[0]) if d else ""


def _is_cpu_device(node: ast.AST, syms) -> bool:
    if astutil.const_str(node) == "cpu":
        return True
    return (isinstance(node, ast.Call)
            and (astutil.dotted(node.func) or "").endswith("device")
            and _head(node.func, syms) == "torch" and len(node.args) == 1
            and astutil.const_str(node.args[0]) == "cpu")


class Bindings:
    """What each local name of one function is bound to where it is read:
    a tensor on its device, a numpy array, or neither, by the function's
    own assignments in line order (a read sees the last binding on an
    earlier line).  Best effort, like the call graph."""

    def __init__(self, fn: ast.AST, syms) -> None:
        self.syms = syms
        # name -> [(line, kind)] in line order; parameters bind at line 0
        self.binds: dict[str, list[tuple[int, str | None]]] = {}
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = astutil.dotted(a.annotation) if a.annotation else None
            if ann and ann.endswith("Tensor") and \
                    _head(a.annotation, syms) == "torch":
                self.binds[a.arg] = [(0, "tensor")]
        assigns = sorted((n for n in own_nodes(fn)
                          if isinstance(n, (ast.Assign, ast.AnnAssign))
                          and n.value is not None),
                         key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            kind = self.kind(node.value)
            line = getattr(node, "end_lineno", node.lineno)
            for t in targets:
                if isinstance(t, ast.Name):
                    self.binds.setdefault(t.id, []).append((line, kind))

    def _name_kind(self, node: ast.Name) -> str | None:
        kind = None
        for line, k in self.binds.get(node.id, ()):
            if line >= node.lineno:
                break
            kind = k
        return kind

    def kind(self, node: ast.AST) -> str | None:
        """"tensor", "array" or None for an expression."""
        if isinstance(node, ast.Name):
            return self._name_kind(node)
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.BinOp):
            kinds = {self.kind(node.left), self.kind(node.right)}
            return "tensor" if "tensor" in kinds else (
                "array" if "array" in kinds else None)
        if isinstance(node, ast.Attribute):
            if node.attr == "T":
                return self.kind(node.value)
            return "array" if _head(node, self.syms) == "numpy" else None
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        head = _head(func, self.syms)
        if head == "numpy":
            return "array"
        if head == "torch":
            name = astutil.dotted(func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if name.count(".") == 1 and leaf not in _TORCH_NON_TENSORS:
                return "tensor"
            return None
        if isinstance(func, ast.Attribute):
            recv = self.kind(func.value)
            if func.attr == "numpy" and recv == "tensor":
                return "array"
            if recv == "tensor" and func.attr not in _HOST_RESULTS:
                return "tensor"
            if recv == "tensor" and func.attr == "to" and not any(
                    _is_cpu_device(a, self.syms) for a in
                    list(node.args) + [k.value for k in node.keywords]):
                return "tensor"
            if recv == "array" and func.attr not in ("tolist", "item"):
                return "array"
        return None


@register
class DevicePathHostSync(ProjectChecker):
    name = "device-path-host-sync"
    description = (".cpu()/.numpy()/.item()/.tolist()/.to('cpu')/"
                   ".synchronize() or np.asarray of a tensor transitively "
                   "reachable from batched launch entry points")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        # device plane: where tensors flow
        in_scope = {path for path, syms in graph.symbols.items()
                    if _imports_top(syms.module.tree, "torch")}
        roots: list[str] = []
        root_of: dict[str, str] = {}
        for spec in ROOTS:
            for qual in graph.lookup(spec):
                if graph.functions[qual].path in in_scope:
                    roots.append(qual)
                    root_of[qual] = spec
        if not roots:
            return
        # BFS with origin tracking so the finding can say WHICH entry
        # point makes the sync reachable
        seen: dict[str, str] = {}
        stack = [(q, root_of[q]) for q in roots]
        while stack:
            cur, origin = stack.pop()
            if cur in seen:
                continue
            seen[cur] = origin
            for dst, fo in graph.calls.get(cur, {}).items():
                fi = graph.functions.get(dst)
                if (fo <= MAX_FANOUT and dst not in seen
                        and fi is not None and fi.path in in_scope):
                    stack.append((dst, origin))
        parented: set[str] = set()
        for qual, origin in sorted(seen.items()):
            fi = graph.functions.get(qual)
            if fi is None:
                continue
            syms = graph.symbols[fi.path]
            if fi.path not in parented:
                astutil.attach_parents(syms.module.tree)
                parented.add(fi.path)
            binds = Bindings(fi.node, syms)
            for node in own_nodes(fi.node):
                if isinstance(node, ast.Call):
                    msg = sync_kind(node, syms, binds)
                    if msg and _on_cpu_branch(node, fi.node):
                        continue
                    if msg:
                        yield Finding(
                            fi.path, node.lineno, self.name,
                            f"{msg} on the batched device path "
                            f"(reachable from {origin}): forces a "
                            f"device->host sync per call -- keep the "
                            f"batch on device, hoist the hop to the "
                            f"single post-launch materialization, or "
                            f"justify with a disable comment")


def sync_kind(node: ast.Call, syms, binds: Bindings) -> str | None:
    """What host sync a call is, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr == "synchronize":
            return f"{astutil.dotted(func) or '.synchronize'}()" \
                if _head(func, syms) == "torch" else ".synchronize()"
        if attr in _METHOD_SYNCS:
            if attr in ("item", "tolist") and node.args:
                return None
            if binds.kind(func.value) == "array" or \
                    _moved_to_host(func.value, syms):
                return None
            return f".{attr}()"
        if attr == "to" and any(
                _is_cpu_device(a, syms) for a in
                list(node.args[:1]) + [k.value for k in node.keywords
                                       if k.arg == "device"]):
            return ".to('cpu')"
        if attr in _NUMPY_SYNCS and _head(func, syms) == "numpy":
            return _numpy_sync(attr, node, binds)
        return None
    if isinstance(func, ast.Name) and func.id in _NUMPY_SYNCS \
            and syms.expand_alias(func.id).startswith("numpy."):
        return _numpy_sync(func.id, node, binds)
    return None


def _moved_to_host(node: ast.AST, syms) -> bool:
    """Is an expression a ``.cpu()`` / ``.to("cpu")`` result (whose own
    call is the sync)?"""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr == "cpu":
        return True
    return node.func.attr == "to" and any(
        _is_cpu_device(a, syms) for a in
        list(node.args[:1]) + [k.value for k in node.keywords
                               if k.arg == "device"])


def _on_cpu_branch(node: ast.AST, fn: ast.AST) -> bool:
    """Does a node sit where a test just said the data is on the CPU: the
    body of ``if <x>.type == "cpu"`` (``xs.device.type``, ``dev.type``) or
    the ``else`` of ``!= "cpu"``?  The port's wrappers take their plain
    version there, and a host read of a host tensor is no sync."""
    child = node
    for anc in astutil.ancestors(node):
        if anc is fn:
            return False
        if isinstance(anc, (ast.If, ast.IfExp)) and child is not anc.test:
            t = anc.test
            if isinstance(t, ast.Compare) and len(t.ops) == 1 and \
                    isinstance(t.left, ast.Attribute) and \
                    t.left.attr == "type" and \
                    astutil.const_str(t.comparators[0]) == "cpu":
                body = anc.body if isinstance(anc.body, list) \
                    else [anc.body]
                in_body = any(child is b for b in body)
                if isinstance(t.ops[0], ast.Eq) and in_body:
                    return True
                if isinstance(t.ops[0], ast.NotEq) and not in_body:
                    return True
        child = anc
    return False


def _numpy_sync(attr: str, node: ast.Call, binds: Bindings) -> str | None:
    if node.args and binds.kind(node.args[0]) == "tensor":
        return f"np.{attr} of a tensor"
    return None
