"""denc-symmetry: encoders and decoders must walk the same fields.

A denc envelope is only forward-compatible if the decoder consumes
exactly the byte sequence the encoder produced -- one transposed
``u32``/``u64`` or a forgotten ``optional`` and every later field
parses as garbage *silently* (fixed-width reads do not fail, they
misalign).  The committed corpus catches drift on types it covers;
this rule catches it at the source level for every pair, including
ones with no corpus entry yet.

For each encode/decode pair -- ``denc``/``dedenc`` methods of one
class, ``encode``/``decode`` methods of one class, or module-level
``_enc_X``/``_dec_X`` functions -- the rule extracts the *field
sequence*: the ordered denc primitive calls on the encoder/decoder
receiver, flattened across control flow (a version-gated field reads
in the same position it was written, so flat order is the invariant).
Structured ops normalize across the calling-convention asymmetry
(``enc.list(items, fn)`` vs ``dec.list(fn)``), element codecs recurse
through lambdas, ``Encoder.u32``-style method refs, and local helper
defs, and a call that passes the receiver onward (``sub.denc(enc)`` /
``Sub.dedenc(dec)``) counts as one nested-codec step.  Pairs where
either side delegates entirely (no receiver ops) are skipped -- there
is no sequence to compare.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..callgraph import CallGraph, _call_base
from ..core import Finding
from ..registry import ProjectChecker, register

# simple ops: one primitive, same name both sides
_SIMPLE = {"u8", "u16", "u32", "u64", "i64", "f64", "boolean", "blob",
           "string", "value", "start", "finish"}
# structured ops: name -> number of element-codec args (taken from the
# END of the arg list -- the encoder passes the data first)
_STRUCTURED = {"optional": 1, "list": 1, "map": 2}

_WILD = ("?",)


def _leaf(node: ast.AST) -> str | None:
    return astutil.name_leaf(node)


def _const_keys_written(root: ast.AST) -> set[str]:
    """Constant string keys a frame packer produces: dict-literal
    keys plus constant subscript stores."""
    out: set[str] = set()
    for node in ast.walk(root):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                ks = astutil.const_str(k) if k is not None else None
                if ks is not None:
                    out.add(ks)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)):
            ks = astutil.const_str(node.slice)
            if ks is not None:
                out.add(ks)
    return out


def _const_keys_read(root: ast.AST) -> set[str]:
    """Constant string keys a frame unpacker consumes: constant
    subscript loads plus ``.get("k", ...)`` calls."""
    out: set[str] = set()
    for node in ast.walk(root):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)):
            ks = astutil.const_str(node.slice)
            if ks is not None:
                out.add(ks)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get" and node.args):
            ks = astutil.const_str(node.args[0])
            if ks is not None:
                out.add(ks)
    return out


class _SeqExtractor:
    """Ordered denc-primitive sequence of one function body."""

    def __init__(self, local_defs: dict[str, ast.AST],
                 depth: int = 0) -> None:
        self.local_defs = local_defs
        self.depth = depth

    def extract(self, body, receiver: str) -> list[tuple]:
        out: list[tuple] = []
        for stmt in body:
            self._emit(stmt, receiver, out)
        return out

    def _emit(self, node, recv: str, out: list[tuple]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return          # element codecs are entered via fn args
        if isinstance(node, ast.Call):
            self._emit_call(node, recv, out)
            return
        for child in ast.iter_child_nodes(node):
            self._emit(child, recv, out)

    def _emit_call(self, node: ast.Call, recv, out) -> None:
        # inner receiver chains first: enc.u32(a).u64(b) emits u32
        # while walking the .u64 call's func
        self._emit(node.func, recv, out)
        fname = _leaf(node.func)
        on_recv = (isinstance(node.func, ast.Attribute)
                   and _call_base(node.func) == recv)
        if on_recv and fname in _STRUCTURED:
            n = _STRUCTURED[fname]
            data_args = node.args[:-n] if len(node.args) >= n else []
            fn_args = node.args[-n:] if len(node.args) >= n else []
            for a in data_args:
                self._emit(a, recv, out)
            sigs = tuple(self._fn_sig(a) for a in fn_args)
            out.append((fname,) + sigs)
            return
        for a in node.args:
            self._emit(a, recv, out)
        for kw in node.keywords:
            self._emit(kw.value, recv, out)
        if on_recv and fname in _SIMPLE:
            out.append((fname,))
        elif not on_recv and self._passes_receiver(node, recv):
            out.append(("sub",))

    @staticmethod
    def _passes_receiver(node: ast.Call, recv: str) -> bool:
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Name) and a.id == recv:
                return True
        return False

    def _fn_sig(self, fn: ast.AST):
        """Normalize an element-codec argument to its own sequence."""
        if self.depth > 6:
            return _WILD
        sub = _SeqExtractor(self.local_defs, self.depth + 1)
        if isinstance(fn, ast.Lambda):
            params = [a.arg for a in fn.args.args]
            if not params:
                return _WILD
            return tuple(sub.extract([fn.body], params[0])) or _WILD
        if isinstance(fn, ast.Attribute):        # Encoder.u32 ref
            return ((fn.attr,),) if fn.attr in _SIMPLE else _WILD
        if isinstance(fn, ast.Name):
            target = self.local_defs.get(fn.id)
            if isinstance(target, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                params = [a.arg for a in target.args.args
                          if a.arg not in ("self", "cls")]
                if not params:
                    return _WILD
                return tuple(sub.extract(target.body,
                                         params[0])) or _WILD
        return _WILD


def _ops_match(a: tuple, b: tuple) -> bool:
    if a == _WILD or b == _WILD:
        return True
    if a[0] != b[0] or len(a) != len(b):
        return False
    for sa, sb in zip(a[1:], b[1:]):
        if sa == _WILD or sb == _WILD:
            continue
        if len(sa) != len(sb):
            return False
        if not all(_ops_match(x, y) for x, y in zip(sa, sb)):
            return False
    return True


def _render(op: tuple) -> str:
    if len(op) == 1:
        return op[0]
    inner = ",".join("/".join(_render(x) for x in sig)
                     if sig != _WILD else "?" for sig in op[1:])
    return f"{op[0]}[{inner}]"


@register
class DencSymmetry(ProjectChecker):
    name = "denc-symmetry"
    description = ("encode/dump field sequence must match what the "
                   "paired decode consumes (denc/dedenc, "
                   "encode/decode, _enc_*/_dec_* pairs)")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        for path in sorted(graph.symbols):
            syms = graph.symbols[path]
            if astutil.imports_module(syms.module.tree, "denc"):
                yield from self._check_module(syms)
            # pack_X/unpack_X frame pairs and the WIRE_CODECS table
            # are wire vocabulary whether or not the module drives a
            # denc Encoder itself (messenger.py does not import denc)
            yield from self._check_pack_pairs(syms)
            yield from self._check_wire_codecs(syms)

    def _check_module(self, syms) -> Iterable[Finding]:
        pairs: list[tuple] = []
        for ci in syms.classes.values():
            for enc_name, dec_name in (("denc", "dedenc"),
                                       ("encode", "decode"),
                                       ("dump", "decode")):
                if enc_name in ci.methods and dec_name in ci.methods:
                    pairs.append((f"{ci.name}.{enc_name}",
                                  ci.methods[enc_name],
                                  f"{ci.name}.{dec_name}",
                                  ci.methods[dec_name]))
        for name, fi in syms.top_funcs.items():
            for pre, dpre in (("_enc_", "_dec_"), ("enc_", "dec_")):
                if name.startswith(pre):
                    dec = syms.top_funcs.get(dpre + name[len(pre):])
                    if dec is not None:
                        pairs.append((name, fi, dec.name, dec))
                    break
        for enc_label, enc_fi, dec_label, dec_fi in pairs:
            enc_seq = self._sequence(enc_fi)
            dec_seq = self._sequence(dec_fi)
            if not enc_seq or not dec_seq:
                continue        # full delegation: nothing to compare
            yield from self._compare(enc_label, enc_seq, dec_label,
                                     dec_fi, dec_seq)

    def _check_pack_pairs(self, syms) -> Iterable[Finding]:
        """``pack_X``/``unpack_X`` frame pairs (the SubOpPipe batch
        vocabulary): every constant dict key the unpacker reads must
        be one the packer writes.  Write-only keys are fine -- length
        metadata can serve other consumers -- but a read of a key the
        encoder never produces is a silent ``None``/KeyError on every
        frame."""
        for name, fi in syms.top_funcs.items():
            if not name.startswith("pack_"):
                continue
            unpack = syms.top_funcs.get("un" + name)
            if unpack is None:
                continue
            written = _const_keys_written(fi.node)
            written |= _const_keys_written(unpack.node)
            missing = sorted(_const_keys_read(unpack.node) - written)
            if missing:
                yield Finding(
                    unpack.path, unpack.lineno, self.name,
                    f"{unpack.name} reads key(s) "
                    f"{', '.join(repr(k) for k in missing)} that "
                    f"{name} never writes -- the frame vocabulary "
                    f"is asymmetric; every unpack of a real frame "
                    f"sees the key missing")

    def _check_wire_codecs(self, syms) -> Iterable[Finding]:
        """Each ``WIRE_CODECS`` entry must map a wire type to a
        conventionally-paired codec whose name matches the type --
        mapping ``"rep_op_reply"`` to ``_enc_rep_op`` by copy-paste
        would silently encode the wrong fixed layout."""
        for stmt in syms.module.tree.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "WIRE_CODECS"
                    and isinstance(stmt.value, ast.Dict)):
                continue
            for k, v in zip(stmt.value.keys, stmt.value.values):
                ks = astutil.const_str(k) if k is not None else None
                if ks is None or not isinstance(v, ast.Tuple) \
                        or len(v.elts) != 2:
                    continue
                enc = _leaf(v.elts[0]) or ""
                dec = _leaf(v.elts[1]) or ""
                es = enc[len("_enc_"):] if enc.startswith("_enc_") \
                    else None
                ds = dec[len("_dec_"):] if dec.startswith("_dec_") \
                    else None
                if es is None or ds is None or es != ds:
                    yield Finding(
                        syms.module.path, k.lineno, self.name,
                        f"WIRE_CODECS['{ks}'] pairs '{enc}' with "
                        f"'{dec}' -- not a matched _enc_X/_dec_X "
                        f"pair; the decoder cannot be assumed to "
                        f"consume what the encoder wrote")
                elif es != ks:
                    yield Finding(
                        syms.module.path, k.lineno, self.name,
                        f"WIRE_CODECS['{ks}'] maps to the "
                        f"'{es}' codec pair -- a type borrowing "
                        f"another type's layout is a copy-paste "
                        f"hazard; give it its own pair or justify "
                        f"the shared layout")

    def _sequence(self, fi) -> list[tuple]:
        recv = self._receiver(fi)
        if recv is None:
            return []
        local_defs = {
            child.name: child
            for child in ast.walk(fi.node)
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))
            and child is not fi.node}
        return _SeqExtractor(local_defs).extract(fi.node.body, recv)

    @staticmethod
    def _receiver(fi) -> str | None:
        """The Encoder/Decoder variable a pair member drives: the
        first non-self/cls parameter for denc-style signatures, else
        the single local assigned ``Encoder()``/``Decoder(...)``."""
        params = [a.arg for a in fi.node.args.args
                  if a.arg not in ("self", "cls")]
        if params and (fi.name in ("denc", "dedenc")
                       or fi.name.startswith(("_enc_", "_dec_",
                                              "enc_", "dec_"))):
            return params[0]
        assigned = []
        for node in ast.walk(fi.node):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _leaf(node.value.func) in ("Encoder",
                                                   "Decoder")
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                assigned.append(node.targets[0].id)
        return assigned[0] if len(assigned) == 1 else None

    def _compare(self, enc_label, enc_seq, dec_label, dec_fi,
                 dec_seq) -> Iterable[Finding]:
        n = min(len(enc_seq), len(dec_seq))
        for i in range(n):
            if not _ops_match(enc_seq[i], dec_seq[i]):
                yield Finding(
                    dec_fi.path, dec_fi.lineno, self.name,
                    f"{dec_label} diverges from {enc_label} at field "
                    f"{i + 1}: encoder writes "
                    f"'{_render(enc_seq[i])}', decoder reads "
                    f"'{_render(dec_seq[i])}' -- every later field "
                    f"misparses silently")
                return
        if len(enc_seq) != len(dec_seq):
            yield Finding(
                dec_fi.path, dec_fi.lineno, self.name,
                f"{dec_label} consumes {len(dec_seq)} field(s) but "
                f"{enc_label} writes {len(enc_seq)} -- the tail "
                f"{'is never read' if len(enc_seq) > len(dec_seq) else 'reads past the encoded payload'}")
