"""Time kernel K1 (``gf2_matmul_popc``) through its wrapper on the card.

    python ceph_tpu_torch/tools/k1_time.py [--root TREE] \
        [--set kPopcWarps=4,kPopcMaxSpan=8]

Imports ``ceph_tpu_torch`` from the repository checkout ``--root`` (default:
the checkout this file is in), builds its K1 and times
``gf2kernels.gf2_matmul_popc`` at the shapes the card's dense route sends to
K1 at full width: RS k=8,m=3 encode on (1024, 8, 131072), the PMSR k=5,m=4
parity product on its sub-chunk rows, (1024, 20, 32768) -> 16, and the PMSR
k=7,m=6 parity product, (1024, 42, 21856) -> 36; two shapes the default
routes do not reach, since the codecs keep chunks 32-byte aligned: RS
k=8,m=3 encode on rows of 131060 bytes (L % 16 = 4: rows that are not
16-byte aligned) and a k=72,m=16 RS parity product on (128, 72, 131072)
(k > 64: more k-steps than K1 holds in registers); and K2
(``gf2_matmul_mma``) at the RS shape beside K1, the other engine for that
shape.  The wrappers' Python signatures are the same in every tree that has
K1 and K2, so one run per tree, in turns (parent, change, change, parent),
compares two commits on one card.  ``--set`` builds a variant of the tree's
``csrc/gf2_matmul.cu`` with those ``constexpr int`` knobs changed, for a
tree whose wrapper has ``_load``.  Each result must equal the plain version
on 8 stripes.  Each of ``REPEATS`` readings is a CUDA-event mean over
``ITERS`` calls after one warm call; the median is reported beside them all
(the host that feeds the calls is shared, and a stalled reading shows as an
outlier).  The XOR-schedule compiler is switched off
(``CEPH_TPU_XOR_SCHED=0``): the codecs' init then compiles no schedule K1
does not use.  Prints one JSON object with the root, the variant, the card's
name and power limit and, where the tree reports them, K1's registers,
shared memory and spills at each shape.
"""

from __future__ import annotations

import argparse
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


def _ptxas_k1(log: str) -> list[str]:
    """ptxas's register and spill lines for each K1 instance in a build log."""
    out = []
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if "popc_kernel" in name:
            lines = [ln.split(":", 1)[-1].strip() for ln in part.splitlines()
                     if "registers" in ln or "spill" in ln]
            out.append(f"{name}: {'; '.join(lines)}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: knobs of csrc/gf2_matmul.cu")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.environ["CEPH_TPU_XOR_SCHED"] = "0"
    import numpy as np
    import torch
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    from ceph_tpu_torch.gf import gen_rs_matrix
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf2kernels as gk

    if not torch.cuda.is_available():
        print("k1_time: no CUDA device", file=sys.stderr)
        return 2
    knobs = kt.knobs(args.set)
    name = "gf2_matmul"
    if knobs:
        name = "gf2_matmul_k1v"
        kt.use_variant(_build, gk, "gf2_matmul.cu", name, knobs)
    built = _build.build([name])
    ptxas = _ptxas_k1(built[name].log) if name in built else []

    dev = torch.device("cuda", torch.cuda.current_device())
    pmsr5, pmsr7 = ErasureCodePmsr(device=dev), ErasureCodePmsr(device=dev)
    pmsr5.init({"k": "5", "m": "4"})
    pmsr7.init({"k": "7", "m": "6"})
    paths = [("rs8/3 encode", gen_rs_matrix(11, 8)[8:], (1024, 8, 131072)),
             ("pmsr5/4 parity", pmsr5.parity_matrix,
              (1024, 5 * pmsr5.alpha, 131072 // pmsr5.alpha)),
             ("pmsr7/6 parity", pmsr7.parity_matrix,
              (1024, 7 * pmsr7.alpha, 131136 // pmsr7.alpha)),
             ("rs8/3 encode, L % 16 = 4", gen_rs_matrix(11, 8)[8:],
              (1024, 8, 131060)),
             ("k=72 r=16", gen_rs_matrix(88, 72)[72:], (128, 72, 131072))]
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for label, mat, shape in paths:
        mat = np.ascontiguousarray(mat, np.uint8)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        runs = {"gf2_matmul_popc": lambda: gk.gf2_matmul_popc(mat, x)}
        if label == "rs8/3 encode":
            g = gk.pick_group(shape[1], shape[0])
            runs["gf2_matmul_mma"] = lambda: gk.gf2_matmul_mma(mat, x, g)
        plain = gk.gf2_matmul_plain(
            torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev), x[:8])
        entry = {"shape": list(shape), "r": mat.shape[0]}
        for kernel, fn in runs.items():
            if not torch.equal(fn()[:8], plain):
                raise RuntimeError(f"{label}: {kernel} differs from the plain "
                                   f"version")
            ms = kt.readings(fn, ITERS, REPEATS)
            tag = "" if kernel == "gf2_matmul_popc" else "k2_"
            entry[f"{tag}ms"] = float(np.median(ms))
            entry[f"{tag}ms_runs"] = ms
        if hasattr(gk, "popc_config"):
            entry["config"] = gk.popc_config(shape[1], mat.shape[0], dev)
        report[label] = entry
        del x
    print(json.dumps({"root": str(root), "set": knobs, "card": kt.card(),
                      "ptxas": ptxas, "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
