"""Time kernel K3 (``xor_sched``) through its wrapper on the card.

    python ceph_tpu_torch/tools/k3_time.py [--root TREE] [--cache FILE] \
        [--design kind=register,tile=64,only=rs4|rs6 ...]

Imports ``ceph_tpu_torch`` from the repository checkout ``--root`` (default:
the checkout this file is in), builds that tree's K3 for each schedule digest
and times ``xor_schedule.xor_sched`` at the shapes the recovery codes launch
at full width: RS k=8,m=3 parity on (1024, 8, 131072) -> 3, LRC k=8,m=4,l=3
encode (1024, 8, 131072) -> 8 and local repair (1024, 3, 131072) -> 1, PMSR
k=5,m=4 parity (1024, 20, 32768) -> 16 and decode [1,6] (1024, 20, 32768) ->
8; an RS k=20,m=4 parity product on (128, 20, 131072) -> 4, a large k off
the routes; and RS k=4,m=2, k=5,m=3, k=6,m=3 and k=7,m=3 parity on (1024,
k, 131072), 32 to 56 input planes, around the register design's threshold.  K1 (``gf2kernels.gf2_matmul_popc``) is timed beside K3 at the
two PMSR shapes, the engine K3 has to beat there.

Each ``--design`` adds a variant of K3, ``xor_sched_codegen.design_for``
with those overrides (``kind``, ``tile`` planes), at every path or at the
paths whose label holds one of the ``|``-separated words of ``only``.  It
is generated by the tree's ``xor_sched_codegen.generate``, built by its
``_build`` and called through its C entry as the wrapper calls the
default; it needs a tree that has ``design_for``.  Every output must equal
``apply_bits_plain`` on 4 stripes.  Each of ``REPEATS`` readings is a
CUDA-event mean over ``ITERS`` calls after one warm call; the median is
reported beside them all.  The schedules' host compile takes ~40 s;
``--cache FILE`` keeps them (JSON) for the next tree's run, so a run in turns
(parent, change, change, parent) pays it once.  Prints one JSON object with
the root, the card's name and power limit and, per path and design, the
design's tag and ptxas's registers, spill bytes and shared memory (from
the log the tree's ``_build`` keeps, for a library built earlier too).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

if __package__:
    from . import kernel_timer as kt
else:                       # run as a script: the module beside this file
    import kernel_timer as kt

ITERS = 20
REPEATS = 5


def _spec(text: str) -> dict:
    out = dict(kv.split("=", 1) for kv in text.split(","))
    return {k: int(v) if k == "tile" else v for k, v in out.items()}


def _variant(build, cg, sched, design) -> str:
    """Register K3 of ``sched`` in ``design`` with the tree's builder; its
    source name."""
    name = cg.source_name(sched, design)
    build.add_generated(name, cg.generate(sched, design))
    return name


def _launcher(build, cg, sched, name: str):
    """x -> K3's output through the C entry of built source ``name``, as
    ``xor_schedule.xor_sched`` calls it (the default stream, no count)."""
    import torch
    fn = getattr(build.library(name), cg.entry_name(sched))
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x):
        b, k, l = x.shape
        out = torch.empty((b, sched.n_out // 8, l), dtype=torch.uint8,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b, k, sched.n_out // 8, l,
                 x.device.index, stream)
        if err:
            raise RuntimeError(f"K3 {name}: launch failed, CUDA error {err}")
        return out
    return run


def _ptxas(build, name: str, built: dict) -> dict:
    """ptxas's registers, shared memory and spill bytes of source ``name``,
    from this run's build or the log a tree's ``_build`` keeps."""
    return kt.ptxas(built[name].log if name in built else (
        build.report(name) if hasattr(build, "report") else ""))


def _paths(dev):
    """(label, GF(2^8) matrix, (B, k, L)) of each path, as flat products."""
    from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    from ceph_tpu_torch.gf import gen_rs_matrix
    lrc = ErasureCodeLrc()
    lrc.init({"k": "8", "m": "4", "l": "3"})
    pmsr = ErasureCodePmsr(device=dev)
    pmsr.init({"k": "5", "m": "4"})
    n, a = pmsr.get_chunk_count(), pmsr.alpha
    plan = pmsr.decode_plan({1, 6}, set(range(n)) - {1, 6})
    sub = 131072 // a
    return [
        ("rs8/3 parity", gen_rs_matrix(11, 8)[8:], (1024, 8, 131072)),
        ("lrc8/4/3 encode", lrc.parity_matrix, (1024, 8, 131072)),
        ("lrc8/4/3 local repair", lrc.repair_matrix((1, 2, 3), (0,)),
         (1024, 3, 131072)),
        ("pmsr5/4 parity", pmsr.parity_matrix, (1024, 5 * a, sub)),
        ("pmsr5/4 decode[1,6]", pmsr.repair_matrix(*plan), (1024, 5 * a, sub)),
        ("rs20/4 parity", gen_rs_matrix(24, 20)[20:], (128, 20, 131072)),
        ("rs4/2 parity", gen_rs_matrix(6, 4)[4:], (1024, 4, 131072)),
        ("rs5/3 parity", gen_rs_matrix(8, 5)[5:], (1024, 5, 131072)),
        ("rs6/3 parity", gen_rs_matrix(9, 6)[6:], (1024, 6, 131072)),
        ("rs7/3 parity", gen_rs_matrix(10, 7)[7:], (1024, 7, 131072)),
    ]


def _schedules(xs, gk, paths, cache: Path | None) -> dict:
    """label -> schedule, compiled or read from the cache (and cached)."""
    saved = json.loads(cache.read_text()) if cache and cache.exists() else {}
    out = {}
    for label, mat, _ in paths:
        bm = gk.bitmatrix_i8(mat)
        rec = saved.get(xs.matrix_digest(bm))
        if rec is None:
            sched = xs.schedule_for(bm)
        else:
            sched = xs.XorSchedule(
                digest=rec["digest"], n_in=rec["n_in"], n_out=rec["n_out"],
                ops=tuple(map(tuple, rec["ops"])), outputs=tuple(rec["outputs"]),
                naive_terms=rec["naive_terms"],
                peak_registers=rec["peak_registers"],
                max_registers=rec["max_registers"])
            with xs._LOCK:
                xs._SCHEDULES.setdefault(sched.digest, sched)
        out[label] = sched
        saved[sched.digest] = {f: getattr(sched, f) for f in (
            "digest", "n_in", "n_out", "ops", "outputs", "naive_terms",
            "peak_registers", "max_registers")}
    if cache:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(saved))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--cache", type=Path, default=None,
                    help="JSON file of compiled schedules, read and written")
    ap.add_argument("--design", action="append", default=[],
                    help="kind=register|tiled[,tile=N][,only=TEXT]")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.environ["CEPH_TPU_XOR_SCHED"] = "0"    # no compile at codec init
    import numpy as np
    import torch
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_sched_codegen as cg
    from ceph_tpu_torch.ops import xor_schedule as xs

    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        return 2
    specs = [_spec(s) for s in args.design]
    if specs and not hasattr(cg, "design_for"):
        raise SystemExit("k3_time: --design needs a tree with design_for")
    dev = torch.device("cuda", torch.cuda.current_device())
    paths = _paths(dev)
    scheds = _schedules(xs, gk, paths, args.cache)

    # every (path, design) to time; None is the tree's own design
    runs = {}
    for label, _, _ in paths:
        runs[label] = [None]
        for spec in specs:
            if any(t in label for t in spec.get("only", "").split("|")):
                over = {k: v for k, v in spec.items() if k != "only"}
                if "tile" in over:
                    over["tile_planes"] = over.pop("tile")
                runs[label].append(cg.design_for(scheds[label], **over))
    names = {}
    for label, designs in runs.items():
        for d in designs:
            names[(label, d)] = (xs.k3_source(scheds[label]) if d is None
                                 else _variant(_build, cg, scheds[label], d))
    built = _build.build(sorted(set(names.values())))

    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for label, mat, shape in paths:
        sched = scheds[label]
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        plain = xs.apply_bits_plain(sched, x[:4])
        entry = {"shape": list(shape), "r": mat.shape[0],
                 "n_terms": sched.n_terms, "naive_terms": sched.naive_terms,
                 "designs": []}
        for d in runs[label]:
            name = names[(label, d)]
            if d is None:
                fn = lambda: xs.xor_sched(sched, x)  # noqa: E731
            else:
                run = _launcher(_build, cg, sched, name)
                fn = lambda run=run: run(x)  # noqa: E731
            if not torch.equal(fn()[:4], plain):
                raise RuntimeError(f"{label}: K3 {d} differs from the plain "
                                   f"version")
            ms = kt.readings(fn, ITERS, REPEATS)
            own = d or (cg.design_for(sched) if hasattr(cg, "design_for")
                        else None)
            entry["designs"].append({
                "design": own.tag if own else "register (tree before "
                                              "design_for)",
                "default": d is None, "ms": float(np.median(ms)), "ms_runs": ms,
                **_ptxas(_build, name, built)})
        if label.startswith("pmsr"):
            fn = lambda: gk.gf2_matmul_popc(mat, x)  # noqa: E731
            want = gk.gf2_matmul_plain(
                torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev), x[:4])
            if not torch.equal(fn()[:4], want):
                raise RuntimeError(f"{label}: K1 differs from the plain version")
            ms = kt.readings(fn, ITERS, REPEATS)
            entry["k1_ms"], entry["k1_ms_runs"] = float(np.median(ms)), ms
        report[label] = entry
        del x
    print(json.dumps({"root": str(root), "card": kt.card(),
                      "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
