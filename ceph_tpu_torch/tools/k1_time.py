"""Time kernel K1 (``gf2_matmul_popc``) through its wrapper on the card.

    python ceph_tpu_torch/tools/k1_time.py [--root TREE]

Imports ``ceph_tpu_torch`` from the repository checkout ``--root`` (default:
the checkout this file is in), builds its K1 and times
``gf2kernels.gf2_matmul_popc`` at the two shapes the card's dense route
sends to K1 at full width: RS k=8,m=3 encode on (1024, 8, 131072) and the
PMSR k=5,m=4 parity product on its sub-chunk rows, (1024, 20, 32768).  The
wrapper's Python signature is the same in every tree that has K1, so one
run per tree, in turns (parent, change, change, parent), compares two
commits on one card.  Each result must equal the plain version on 8
stripes.  Each of ``REPEATS`` readings is a CUDA-event mean over
``ITERS`` calls after one warm call; the median is reported beside them
all (the host that feeds the calls is shared, and a stalled reading shows
as an outlier).  The XOR-schedule compiler is switched off
(``CEPH_TPU_XOR_SCHED=0``): the codec's init then compiles no schedule K1
does not use.  Prints one JSON object with the root, the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ITERS = 20
REPEATS = 5


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    os.environ["CEPH_TPU_XOR_SCHED"] = "0"
    import numpy as np
    import torch
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    from ceph_tpu_torch.gf import gen_rs_matrix
    from ceph_tpu_torch.ops import gf2kernels as gk

    if not torch.cuda.is_available():
        print("k1_time: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    pmsr = ErasureCodePmsr(device=dev)
    pmsr.init({"k": "5", "m": "4"})
    paths = [("rs8/3 encode", gen_rs_matrix(11, 8)[8:], (1024, 8, 131072)),
             ("pmsr5/4 parity", pmsr.parity_matrix,
              (1024, 5 * pmsr.alpha, 131072 // pmsr.alpha))]
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for label, mat, shape in paths:
        mat = np.ascontiguousarray(mat, np.uint8)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        out = gk.gf2_matmul_popc(mat, x)
        plain = gk.gf2_matmul_plain(
            torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev), x[:8])
        if not torch.equal(out[:8], plain):
            raise RuntimeError(f"{label}: K1 differs from the plain version")
        runs = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                gk.gf2_matmul_popc(mat, x)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / ITERS)
        report[label] = {"shape": list(shape), "r": mat.shape[0],
                         "ms": float(np.median(runs)), "ms_runs": runs}
        del x, out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "card": smi.stdout.strip().splitlines()[0],
                      "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
