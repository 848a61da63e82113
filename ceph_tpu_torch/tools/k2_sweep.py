"""Time variants of kernel K2 (``gf2_matmul_mma``) on the card, in turns.

    python -m ceph_tpu_torch.tools.k2_sweep [--set kMmaRing=2 ...] \
        [--source OTHER/gf2_matmul.cu ...] [--iters 10]

The first variant is ``csrc/gf2_matmul.cu`` as it stands.  Each ``--set
NAME=VALUE[,NAME=VALUE]`` adds the same source with those ``constexpr int``
knobs changed, and each ``--source FILE`` adds another K2 source with the
same C entry (an older commit's, for a before/after in one run).  All
variants build at once, one nvcc each.  At each of K2's paths (RS k=8,m=3
encode and decode [1,9], Cauchy 10/4 decode [2,11], LRC k=8,m=4,l=3 dense
encode, at the sizes ``chip_smoke.py`` drives) every variant's output must
equal the first variant's byte for byte, and the first variant's the plain
version's on 8 stripes.  Times are CUDA-event means over ``--iters``
launches, taken in turns (first to last, then last to first).  Prints one
JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ec.plugins.lrc import ErasureCodeLrc
from ..gf import build_decode_matrix, gen_cauchy1_matrix, gen_rs_matrix
from ..ops import _build
from ..ops import gf2kernels as gk

# (label, matrix, (B, k, L)) of each path K2 serves
def _paths() -> list[tuple[str, np.ndarray, tuple[int, int, int]]]:
    rs = gen_rs_matrix(11, 8)
    cauchy = gen_cauchy1_matrix(14, 10)
    lrc = ErasureCodeLrc()
    lrc.init({"k": "8", "m": "4", "l": "3"})
    return [
        ("rs8/3 encode", rs[8:], (1024, 8, 131072)),
        ("rs8/3 decode[1,9]", build_decode_matrix(rs, 8, [1, 9])[0],
         (1024, 8, 131072)),
        ("cauchy10/4 decode[2,11]", build_decode_matrix(cauchy, 10, [2, 11])[0],
         (128, 10, 131072)),
        ("lrc8/4/3 encode", lrc.parity_matrix, (1024, 8, 131072)),
    ]


def variant_text(base: str, knobs: dict[str, int]) -> str:
    """``base`` with each ``constexpr int NAME = ...;`` set to the value."""
    for name, value in knobs.items():
        base, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};",
                          base)
        if n != 1:
            raise ValueError(f"knob {name} not found once in the source")
    return base


def _load(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.gf2_matmul_mma.argtypes = [v, v, v, i, i, i, i, ctypes.c_longlong, i, v]
    lib.gf2_matmul_mma.restype = i
    return lib


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: a variant with those knobs")
    ap.add_argument("--source", action="append", default=[],
                    help="another K2 source file with the same C entry")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_sweep: no CUDA device", file=sys.stderr)
        return 2

    base = (_build.CSRC / "gf2_matmul.cu").read_text()
    variants = {"base": base}
    for spec in args.set:
        knobs = dict(kv.split("=", 1) for kv in spec.split(","))
        variants[spec] = variant_text(base, {k: int(v) for k, v in knobs.items()})
    for path in args.source:
        variants[path] = Path(path).read_text()
    names = {}
    for i, (label, text) in enumerate(variants.items()):
        names[label] = f"gf2_matmul_k2v{i}"
        _build.add_generated(names[label], text)
    _build.build(list(names.values()))
    libs = {label: _load(name) for label, name in names.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for label, mat, (b, k, l) in _paths():
        mat = np.ascontiguousarray(mat, np.uint8)
        r = mat.shape[0]
        g = gk.pick_group(k, b)
        x = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                          generator=gen)
        w = gk._w_mma_device(mat.tobytes(), r, k, g, dev)
        outs = {v: torch.empty((b, r, l), dtype=torch.uint8, device=dev)
                for v in libs}

        def launch(v: str) -> None:
            err = libs[v].gf2_matmul_mma(w.data_ptr(), x.data_ptr(),
                                         outs[v].data_ptr(), b, k, r, g, l,
                                         dev.index, stream)
            if err:
                raise RuntimeError(f"{v}: launch failed with CUDA error {err}")

        for v in libs:
            launch(v)
        torch.cuda.synchronize()
        plain = gk.gf2_matmul_grouped_plain(
            torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev), x[:8], g)
        if not torch.equal(outs["base"][:8], plain):
            raise RuntimeError(f"{label}: base differs from the plain version")
        for v in libs:
            if not torch.equal(outs[v], outs["base"]):
                raise RuntimeError(f"{label}: {v} differs from base")
        order = list(libs)
        times = {v: [] for v in order}
        for turn in (order, order[::-1]):
            for v in turn:
                times[v].append(_time_ms(lambda: launch(v), args.iters))
        config = {}
        for v, lib in libs.items():
            try:
                fn = lib.gf2_mma_config
            except AttributeError:      # a source from before the query
                continue
            info = (ctypes.c_int * 4)()
            if fn(k, r, g, dev.index, info) == 0:
                config[v] = dict(zip(("registers", "smem_bytes",
                                      "blocks_per_sm", "local_bytes"), info))
        report[label] = {
            "shape": [b, k, l], "r": r, "g": g, "config": config,
            "ms": {v: round(sum(t) / len(t), 4) for v, t in times.items()},
            "ms_turns": {v: [round(t, 4) for t in ts] for v, ts in times.items()},
        }
        del x, outs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0],
                      "variants": list(variants), "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
