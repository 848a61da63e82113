"""Time kernel K4 (``crc32c_chunks``) through its wrapper on the card.

    python ceph_tpu_torch/tools/k4_time.py [--root TREE] \
        [--set kCopies=1,kUnroll=4] [--plan _MAX_ROUNDS=64]

Imports ``ceph_tpu_torch`` from the repository checkout ``--root`` (default:
the checkout this file is in), builds its K4 and times
``crc32c_batch.crc32c_chunks`` at the shapes the card sends to K4: the fused
RS k=8,m=3 encode's two sets of rows, its data (8192, 131072) and its parity
(3072, 131072), and a few long rows as ``crc32c_resident`` cuts 64 MiB,
(256, 262144); and, where the tree has it, the one-launch entry
``crc32c_chunks_pair`` over that data and parity together.  The wrapper's
Python signature is the same in every tree that has K4, so one run per tree,
in turns (parent, change, change, parent), compares two commits on one card.
``--set`` builds a variant of the tree's ``csrc/crc32c.cu`` with those
``constexpr int`` knobs changed, and ``--plan`` sets constants of the
wrapper's span plan, for a tree whose wrapper has ``_load``.  Each result
must equal the plain version on 8 rows.  Each of ``REPEATS`` readings is a
CUDA-event mean over ``ITERS`` calls after one warm call; the median is
reported beside them all.  Prints one JSON object with the root, the
variant, the card's name and power limit and, where the tree reports them,
K4's registers and shared memory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__:
    from . import kernel_timer as kt
else:                       # run as a script: the module beside this file
    import kernel_timer as kt

ITERS = 20
REPEATS = 5


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: knobs of csrc/crc32c.cu")
    ap.add_argument("--plan", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: the wrapper's plan constants")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import crc32c_batch as crc

    if not torch.cuda.is_available():
        print("k4_time: no CUDA device", file=sys.stderr)
        return 2
    knobs, plan = kt.knobs(args.set), kt.knobs(args.plan)
    if knobs:
        kt.use_variant(_build, crc, "crc32c.cu", "crc32c_k4v", knobs)
    for key, value in plan.items():
        if not hasattr(crc, key):
            raise ValueError(f"the wrapper has no plan constant {key}")
        setattr(crc, key, value)

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randint(0, 256, (1024, 8, 131072), dtype=torch.uint8,
                         device=dev, generator=gen)
    parity = torch.randint(0, 256, (1024, 3, 131072), dtype=torch.uint8,
                           device=dev, generator=gen)
    resident = torch.randint(0, 256, (256, 262144), dtype=torch.uint8,
                             device=dev, generator=gen)
    paths = [("rs8/3 fused data (8192, 131072)",
              lambda: crc.crc32c_chunks(data), data.reshape(-1, 131072)),
             ("rs8/3 fused parity (3072, 131072)",
              lambda: crc.crc32c_chunks(parity), parity.reshape(-1, 131072)),
             ("resident 64 MiB (256, 262144)",
              lambda: crc.crc32c_chunks(resident), resident)]
    if hasattr(crc, "crc32c_chunks_pair"):
        paths.append(("rs8/3 fused data + parity, one launch",
                      lambda: torch.cat([c.reshape(-1) for c in
                                         crc.crc32c_chunks_pair(data, parity)]),
                      torch.cat([data.reshape(-1, 131072)[:4],
                                 parity.reshape(-1, 131072)[:4]])))
    report = {}
    for label, fn, rows in paths:
        out = fn().reshape(-1)
        want = crc.crc32c_chunks_plain(rows[:8])
        got = out[:8] if "one launch" not in label else torch.cat(
            [out[:4], out[8192:8196]])
        if not torch.equal(got, want):
            raise RuntimeError(f"{label}: K4 differs from the plain version")
        runs = kt.readings(fn, ITERS, REPEATS)
        report[label] = {"ms": float(np.median(runs)), "ms_runs": runs}
    report["rs8/3 fused, two launches"] = {"ms": sum(
        report[k]["ms"] for k in list(report)[:2])}
    config = crc.kernel_config(dev) if hasattr(crc, "kernel_config") else None
    print(json.dumps({"root": str(root), "set": knobs, "plan": plan,
                      "card": kt.card(), "config": config, "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
