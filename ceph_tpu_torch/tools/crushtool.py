"""crushtool analog: crushmap text grammar + placement simulator.

Mirrors the reference's CrushCompiler text format (src/crush/
CrushCompiler.cc: tunables/devices/types/buckets/rules sections) and
`crushtool --test` (src/tools/crushtool.cc:546 / CrushTester): compile
a text map, decompile one back, and simulate mappings over an x range
with per-device utilization -- placement what-ifs with zero daemons.

Port of ``ceph_tpu/tools/crushtool.py``, copied; ``--test`` maps the x
range with the port's ``bulk_crush`` (K5 on the card past
``FUSED_MIN_LANES``, ``--device cpu`` for the plain version and the scalar
sweep on the host).

Usage:
  python -m ceph_tpu_torch.tools.crushtool -c map.txt -o map.json
  python -m ceph_tpu_torch.tools.crushtool -d map.json
  python -m ceph_tpu_torch.tools.crushtool --test -i map.json \
      --rule 0 --num-rep 3 --min-x 0 --max-x 1023 [--show-utilization]
      [--weight OSD W]... [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from ..crush import CrushMap
from ..crush.state import crush_map_from_dict, crush_to_dict
from ..crush.types import (
    CRUSH_ITEM_NONE,
    Bucket, Rule, RuleStep, Tunables,
    CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_RULE_TYPE_REPLICATED, CRUSH_RULE_TYPE_ERASURE,
    CRUSH_RULE_TAKE, CRUSH_RULE_EMIT,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
)

ALGS = {"uniform": CRUSH_BUCKET_UNIFORM, "list": CRUSH_BUCKET_LIST,
        "tree": CRUSH_BUCKET_TREE, "straw": CRUSH_BUCKET_STRAW,
        "straw2": CRUSH_BUCKET_STRAW2}
ALG_NAMES = {v: k for k, v in ALGS.items()}
RULE_TYPES = {"replicated": CRUSH_RULE_TYPE_REPLICATED,
              "erasure": CRUSH_RULE_TYPE_ERASURE}
RULE_TYPE_NAMES = {v: k for k, v in RULE_TYPES.items()}
TUNABLE_FIELDS = {
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once",
    "chooseleaf_vary_r", "chooseleaf_stable",
}


class CompileError(ValueError):
    pass


class _Tokens:
    """Flat token stream (the grammar is token-, not line-based; the
    reference compiler uses a spirit grammar the same way)."""

    def __init__(self, text: str) -> None:
        toks: list[str] = []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0]
            for word in line.replace("{", " { ").replace("}", " } ") \
                            .split():
                toks.append(word)
        self.toks = toks
        self.pos = 0

    def peek(self) -> str | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self, what: str = "token") -> str:
        if self.pos >= len(self.toks):
            raise CompileError(f"unexpected end of map, wanted {what}")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, tok: str) -> None:
        got = self.next(tok)
        if got != tok:
            raise CompileError(f"expected {tok!r}, got {got!r}")

    def next_int(self, what: str) -> int:
        t = self.next(what)
        try:
            return int(t)
        except ValueError:
            raise CompileError(f"{what}: not an integer: {t!r}")


def compile_text(text: str):
    """Text crushmap -> (CrushMap, type names, device ids)."""
    ts = _Tokens(text)
    cm = CrushMap()
    tun: dict[str, int] = {}
    types: dict[str, int] = {}
    type_names: dict[int, str] = {}
    devices: dict[str, int] = {}
    names: dict[str, int] = {}     # bucket name -> id

    def item_id(name: str) -> int:
        if name in devices:
            return devices[name]
        if name in names:
            return names[name]
        raise CompileError(f"unknown item {name!r}")

    while (tok := ts.peek()) is not None:
        if tok == "tunable":
            ts.next()
            name = ts.next("tunable name")
            if name not in TUNABLE_FIELDS:
                raise CompileError(f"unknown tunable {name}")
            tun[name] = ts.next_int("tunable value")
        elif tok == "device":
            ts.next()
            did = ts.next_int("device id")
            devices[ts.next("device name")] = did
        elif tok == "type":
            ts.next()
            tid = ts.next_int("type id")
            tname = ts.next("type name")
            types[tname] = tid
            type_names[tid] = tname
        elif tok in types:
            btype = types[ts.next()]
            bname = ts.next("bucket name")
            ts.expect("{")
            bid = None
            alg = CRUSH_BUCKET_STRAW2
            bhash = 0
            items: list[int] = []
            weights: list[int] = []
            while (st := ts.next("bucket body")) != "}":
                if st == "id":
                    bid = ts.next_int("bucket id")
                elif st == "alg":
                    a = ts.next("alg")
                    if a not in ALGS:
                        raise CompileError(f"unknown alg {a}")
                    alg = ALGS[a]
                elif st == "hash":
                    bhash = ts.next_int("hash")
                elif st == "item":
                    iname = ts.next("item name")
                    w = 0x10000
                    if ts.peek() == "weight":
                        ts.next()
                        w = int(round(float(ts.next("weight"))
                                      * 0x10000))
                    items.append(item_id(iname))
                    weights.append(w)
                else:
                    raise CompileError(f"bad bucket token: {st!r}")
            if bid is None:
                raise CompileError(f"bucket {bname} has no id")
            cm.add_bucket(Bucket(id=bid, type=btype, alg=alg,
                                 hash=bhash, items=items,
                                 item_weights=weights), bname)
            names[bname] = bid
        elif tok == "rule":
            ts.next()
            ts.next("rule name")
            ts.expect("{")
            rid = None
            rtype = CRUSH_RULE_TYPE_REPLICATED
            steps: list[RuleStep] = []
            while (st := ts.next("rule body")) != "}":
                if st == "id":
                    rid = ts.next_int("rule id")
                elif st == "type":
                    tv = ts.next("rule type")
                    if tv in RULE_TYPES:
                        rtype = RULE_TYPES[tv]
                    elif tv.isdigit():
                        rtype = int(tv)
                    else:
                        raise CompileError(f"bad rule type {tv}")
                elif st in ("min_size", "max_size"):
                    ts.next()            # legacy, ignored
                elif st == "step":
                    steps.append(_parse_step(ts, names, types))
                else:
                    raise CompileError(f"bad rule token: {st!r}")
            if rid is None:
                raise CompileError("rule has no id")
            cm.add_rule(Rule(rule_id=rid, type=rtype, steps=steps))
        else:
            raise CompileError(f"unexpected token: {tok!r}")
    if tun:
        cm.tunables = Tunables(**{**cm.tunables.__dict__, **tun})
    return cm, type_names, sorted(devices.values())


def _parse_step(ts: _Tokens, names, types) -> RuleStep:
    op = ts.next("step op")
    if op == "take":
        b = ts.next("take bucket")
        if b not in names:
            raise CompileError(f"take: unknown bucket {b}")
        return RuleStep(CRUSH_RULE_TAKE, names[b])
    if op == "emit":
        return RuleStep(CRUSH_RULE_EMIT)
    ops = {("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
           ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
           ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
           ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP}
    mode = ts.next("choose mode")
    key = (op, mode)
    if key not in ops:
        raise CompileError(f"bad step: {op} {mode}")
    n = ts.next_int("choose n")
    ts.expect("type")
    tname = ts.next("choose type")
    if tname not in types:
        raise CompileError(f"unknown type {tname}")
    return RuleStep(ops[key], n, types[tname])


def decompile(cm: CrushMap, type_names: dict[int, str] | None = None,
              devices: list[int] | None = None) -> str:
    type_names = dict(type_names or {0: "osd", 1: "host", 10: "root"})
    # every bucket/choose type needs a declaration or the emitted text
    # cannot recompile
    seen = {b.type for b in cm.buckets.values()} | {0}
    for r in cm.rules.values():
        seen |= {st.arg2 for st in r.steps
                 if st.op not in (CRUSH_RULE_TAKE, CRUSH_RULE_EMIT)}
    for t_ in sorted(seen):
        type_names.setdefault(t_, f"type{t_}")
    if devices is None:
        devices = sorted({i for b in cm.buckets.values()
                          for i in b.items if i >= 0})
    out = ["# begin crush map"]
    t = cm.tunables
    for f in sorted(TUNABLE_FIELDS):
        out.append(f"tunable {f} {int(getattr(t, f))}")
    out.append("\n# devices")
    for d in devices:
        out.append(f"device {d} osd.{d}")
    out.append("\n# types")
    for tid in sorted(type_names):
        out.append(f"type {tid} {type_names[tid]}")
    out.append("\n# buckets")

    def bname(bid: int) -> str:
        return cm.bucket_names.get(bid, f"bucket{-bid}")

    # children before parents (the compiler needs items defined first)
    emitted: set[int] = set()

    def emit_bucket(b: Bucket):
        if b.id in emitted:
            return
        for item in b.items:
            if item < 0 and item in cm.buckets:
                emit_bucket(cm.buckets[item])
        emitted.add(b.id)
        tname = type_names.get(b.type, str(b.type))
        out.append(f"{tname} {bname(b.id)} {{")
        out.append(f"\tid {b.id}")
        out.append(f"\talg {ALG_NAMES.get(b.alg, b.alg)}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for item, w in zip(b.items, b.item_weights):
            iname = f"osd.{item}" if item >= 0 else bname(item)
            out.append(f"\titem {iname} weight {w / 0x10000:.5f}")
        out.append("}")

    for b in cm.buckets.values():
        emit_bucket(b)
    out.append("\n# rules")
    step_names = {CRUSH_RULE_CHOOSE_FIRSTN: "choose firstn",
                  CRUSH_RULE_CHOOSE_INDEP: "choose indep",
                  CRUSH_RULE_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
                  CRUSH_RULE_CHOOSELEAF_INDEP: "chooseleaf indep"}
    for r in cm.rules.values():
        out.append(f"rule rule{r.rule_id} {{")
        out.append(f"\tid {r.rule_id}")
        out.append(f"\ttype {RULE_TYPE_NAMES.get(r.type, r.type)}")
        for s in r.steps:
            if s.op == CRUSH_RULE_TAKE:
                out.append(f"\tstep take {bname(s.arg1)}")
            elif s.op == CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            elif s.op in step_names:
                tname = type_names.get(s.arg2, str(s.arg2))
                out.append(f"\tstep {step_names[s.op]} {s.arg1} "
                           f"type {tname}")
        out.append("}")
    out.append("\n# end crush map")
    return "\n".join(out) + "\n"


def run_test(cm: CrushMap, ruleno: int, numrep: int, min_x: int,
             max_x: int, weights: dict[int, float],
             show_utilization: bool, out=sys.stdout, device=None) -> dict:
    import numpy as np

    from ..mon.pg_mapping import bulk_crush

    n = max([i for b in cm.buckets.values() for i in b.items
             if i >= 0] + [o for o in weights], default=-1) + 1
    w = [0x10000] * n
    for osd, wf in weights.items():
        w[osd] = int(round(wf * 0x10000))
    counts: dict[int, int] = defaultdict(int)
    sizes: dict[int, int] = defaultdict(int)
    # the whole x range maps in ONE bulk launch through the same
    # helper the placement cache rides (fused when the shape compiles
    # and the range is large enough, scalar sweep otherwise) -- the
    # simulator exercises the production bulk path, not a private one
    rule = cm.rules.get(ruleno)
    firstn = rule is not None and any(
        s.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
        for s in rule.steps)
    xs = np.arange(min_x, max_x + 1, dtype=np.int64)
    rows, _ = bulk_crush(cm, ruleno, xs, numrep, w, device=device)
    for x, row in zip(xs, rows):
        res = [int(r) for r in row]
        if firstn:
            # scalar firstn returns a compacted vector with no NONE
            # padding; strip it so output matches crush_do_rule's
            res = [r for r in res if r != CRUSH_ITEM_NONE]
        elif rule is None:
            res = []
        print(f"CRUSH rule {ruleno} x {x} {res}", file=out)
        sizes[len([r for r in res if 0 <= r < n])] += 1
        for r in res:
            if 0 <= r < n:
                counts[r] += 1
    total = max_x - min_x + 1
    for sz in sorted(sizes):
        print(f"rule {ruleno} ({ruleno}) num_rep {numrep} "
              f"result size == {sz}:\t{sizes[sz]}/{total}", file=out)
    if show_utilization:
        for osd in sorted(counts):
            print(f"  device {osd}:\t stored : {counts[osd]}", file=out)
    return {"counts": dict(counts), "sizes": dict(sizes)}


def _load_map(path: str):
    with open(path) as f:
        content = f.read()
    if content.lstrip().startswith("{"):
        return crush_map_from_dict(json.loads(content)), None, None
    cm, type_names, devices = compile_text(content)
    return cm, type_names, devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("-c", "--compile", metavar="TXT",
                    help="compile a text map")
    ap.add_argument("-d", "--decompile", metavar="MAP",
                    help="decompile a map (json or text)")
    ap.add_argument("-i", "--in-map", metavar="MAP")
    ap.add_argument("-o", "--out-file", metavar="OUT")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--weight", nargs=2, action="append", default=[],
                    metavar=("OSD", "W"))
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="--test's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.compile:
        cm, _, _ = _load_map(args.compile)
        blob = json.dumps(crush_to_dict(cm), indent=1)
        if args.out_file:
            with open(args.out_file, "w") as f:
                f.write(blob)
        else:
            print(blob)
        return 0
    if args.decompile:
        cm, type_names, devices = _load_map(args.decompile)
        text = decompile(cm, type_names, devices)
        if args.out_file:
            with open(args.out_file, "w") as f:
                f.write(text)
        else:
            print(text, end="")
        return 0
    if args.test:
        if not args.in_map:
            ap.error("--test requires -i/--in-map")
        cm, _, _ = _load_map(args.in_map)
        run_test(cm, args.rule, args.num_rep, args.min_x, args.max_x,
                 {int(o): float(w) for o, w in args.weight},
                 args.show_utilization, device=args.device)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
