"""Time kernel K5 (``crush_map_rule``) through its wrapper on the card.

    python ceph_tpu_torch/tools/k5_time.py [--root TREE] \
        [--set kFmaSubs=0,kThreads=128] [--sass FILE]

Imports ``ceph_tpu_torch`` from the repository checkout ``--root`` (default:
the checkout this file is in), builds its K5 and times
``vectorized.crush_map_rule`` at ``BASELINE.md`` config 5 (the 1000-OSD map
of ``tools/crush_bench.py``, fanouts 5/5/4/10, one launch of 2M lanes of its
seeds) at rule 0 (chooseleaf firstn) x3 and rule 1 (chooseleaf indep) x11,
and on a 16,000-OSD map (10/10/16/10) too large for K5 to stage in shared
memory, at 262,144 lanes, both rules (and config 5 at 262,144 lanes beside
it), and on maps of 12,000 and 9,000 OSDs (10/10/12/10, 10/10/9/10), which
a K5 that stages up to 40,960 words holds in shared memory, one or both.  The wrapper's
Python signature is the same in every tree that has K5, so one run per
tree, in turns (parent, change, change, parent), compares two commits on
one card.  ``--set``
builds a variant of the tree's ``csrc/crush.cu`` with those ``constexpr
int`` knobs changed, for a tree whose wrapper has ``_load``.  Each output
must equal the plain version on its first ``CHECK_LANES`` lanes.  Each of
``REPEATS`` readings is a CUDA-event mean over ``ITERS`` calls after one warm
call; the median is reported beside them all.

Prints one JSON object with the root, the variant, the card's name and power
limit, K5's registers and spill bytes from ptxas (the log the tree's
``_build`` keeps) and, where the toolkit has ``cuobjdump``, K5's SASS counted
by issue pipe: the whole kernel, and each innermost loop that holds a
straw2 draw (45 XORs of ``hash32_3``'s mixes) with its instructions a draw
and the size of any routine it calls.  ``--sass FILE`` also writes the
disassembly there.
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

ITERS = 10
REPEATS = 5
CHECK_LANES = 4096
# maps beside config 5, (label, fanouts), each read from global memory by a
# K5 that stages at most 8,192 words; one that stages 40,960 stages the
# 9,000-OSD map (40,068 words at 4 words a child) and, at 3, the 12,000
SIDE_MAPS = (("global map", [10, 10, 16, 10]),
             ("12000-OSD map", [10, 10, 12, 10]),
             ("9000-OSD map", [10, 10, 9, 10]))
GLOBAL_LANES = 262144
XORS_A_DRAW = 45            # hash32_3: 5 mixes of 9 xor-with-shift lines


def sass_counts(text: str) -> dict:
    """K5's SASS by pipe: the kernel's totals and each innermost loop with a
    straw2 draw in it (at least ``XORS_A_DRAW`` - 5 LOP3s), with its
    instructions a draw, the routines it calls counted in."""
    sass = kt.Sass(text)
    draws = []
    for s, e in sass.innermost_loops():
        c = sass.count(s, e)
        xors = c["by_opcode"].get("LOP3", 0)
        if xors < XORS_A_DRAW - 5:
            continue
        calls = sass.calls(s, e)
        n_draws = max(1, round(xors / XORS_A_DRAW))
        draws.append({"at": [hex(sass.ins[s][0]), hex(sass.ins[e][0])],
                      "draws": n_draws,
                      "instructions_a_draw": (c["instructions"] + sum(
                          x["instructions"] for x in calls)) / n_draws,
                      **c, "calls": calls})
    return {"kernel": sass.kernel(), "draw_loops": draws}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: knobs of csrc/crush.cu")
    ap.add_argument("--sass", default=None,
                    help="write K5's disassembly to this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from ceph_tpu_torch.crush import vectorized as vec
    from ceph_tpu_torch.crush.builder import build_hierarchy
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.tools.crush_bench import config5_map

    if not torch.cuda.is_available():
        print("k5_time: no CUDA device", file=sys.stderr)
        return 2
    knobs = kt.knobs(args.set)
    name = "crush"
    if knobs:
        name = "crush_k5v"
        kt.use_variant(_build, vec, "crush.cu", name, knobs)

    dev = torch.device("cuda", torch.cuda.current_device())
    cm5 = config5_map(1000)[0]
    xs5 = np.random.default_rng(0).integers(0, 2**31 - 1, 2_000_000,
                                            dtype=np.int64)
    xsg = np.random.default_rng(1).integers(0, 2**32, GLOBAL_LANES,
                                            dtype=np.int64)
    cases = [("config 5 rule 0 x3, 2M lanes", cm5, 0, 3, xs5),
             ("config 5 rule 1 x11, 2M lanes", cm5, 1, 11, xs5),
             ("config 5 rule 0 x3, 262144 lanes", cm5, 0, 3, xs5[:GLOBAL_LANES]),
             ("config 5 rule 1 x11, 262144 lanes", cm5, 1, 11, xs5[:GLOBAL_LANES])]
    for label, fanouts in SIDE_MAPS:
        cm = build_hierarchy(fanouts)
        cases += [(f"{label} rule 0 x3, 262144 lanes", cm, 0, 3, xsg),
                  (f"{label} rule 1 x11, 262144 lanes", cm, 1, 11, xsg)]
    report = {}
    for label, cm, rule, numrep, xs in cases:
        vc = vec.VectorCrush(cm, rule, device=dev)
        w = vc.device_weights([0x10000] * cm.max_devices)
        seeds = torch.from_numpy(xs.astype(np.uint32).view(np.int32)).to(dev)

        def fn():
            return vec.crush_map_rule(vc.map_words, seeds, numrep, w)
        got = fn()[:CHECK_LANES]
        plain = vc.map_firstn if vc.firstn else vc.map_indep
        if not torch.equal(got, plain(seeds[:CHECK_LANES], numrep, w)):
            raise RuntimeError(f"{label}: K5 differs from the plain version")
        runs = kt.readings(fn, ITERS, REPEATS)
        words = int(vc.map_words.shape[0])
        report[label] = {"ms": float(np.median(runs)), "ms_runs": runs,
                         "map_words": words,
                         "config": vec.kernel_config(words, dev)}
    sass = kt.sass(_build._lib_path(name), _build.nvcc_path())
    if sass is not None and args.sass:
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(sass)
    print(json.dumps({"root": str(root), "set": knobs, "card": kt.card(),
                      "ptxas": kt.ptxas(_build.report(name)),
                      "sass": sass_counts(sass) if sass is not None else None,
                      "paths": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
