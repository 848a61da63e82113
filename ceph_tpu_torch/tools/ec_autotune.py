"""Dense vs scheduled: tune the GF(2) engine choice on the live device.

The engine sweep of ``ceph_tpu/tools/ec_autotune.py``: per matrix family it
times the dense bit-matmul kernels (K1/K2) against the CSE-minimised XOR
schedule (K3), checks both against the host oracle, and records the winner
under the ``"xor_sched"`` key of the tuned table that the cost model
(``ops.xor_schedule.want_scheduled``) reads.  ``--codes lrc,pmsr`` extends
the sweep to the recovery-code matrices (LRC local-parity / local-repair,
PMSR parity / fragment-aggregate), keyed by their matrix dims.  Times are
CUDA events on the card and the host clock on the CPU.

    python -m ceph_tpu_torch.tools.ec_autotune --k 8 --m 3 --codes lrc,pmsr \\
        --batch 1024 --chunk 131072 --write

``--cpu-smoke`` shrinks the shapes and runs on the CPU (the plain versions),
so the harness runs under the CPU tests; pair it with ``--out`` to keep
smoke winners out of the real tuned file.  The TPU's Pallas config sweep has
no counterpart here yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stage_batch(rng, batch: int, k: int, chunk: int,
                device: torch.device) -> torch.Tensor:
    assert batch % 8 == 0, "batch must be a multiple of 8"
    seed_rows = min(batch, 8)
    seed = rng.integers(0, 256, size=(seed_rows, k, chunk), dtype=np.uint8)
    return torch.from_numpy(seed).to(device).repeat(batch // seed_rows, 1, 1)


def sweep_engines(k: int, m: int, batch: int, chunk: int,
                  device: torch.device, iters: int = 8) -> dict:
    """Dense vs scheduled on the RS (k, m) parity matrix (the headline
    family): see ``sweep_matrix_engines``."""
    from ..gf import gen_rs_matrix
    gen = gen_rs_matrix(k + m, k)
    return sweep_matrix_engines(np.ascontiguousarray(gen[k:], np.uint8),
                                batch, chunk, device, iters=iters)


def code_matrices(codes: list[str], device: torch.device,
                  smoke: bool = False) -> list[tuple[str, np.ndarray]]:
    """The recovery-code GF(2^8) matrix families worth a tuned entry:
    LRC local-parity/local-repair rows and PMSR parity/repair-aggregate
    matrices.  Tags name the provenance; the tuned keys are derived from
    the matrix dims (the key ``want_scheduled`` looks up at run time).
    Smoke swaps the pmsr shape down to k=3 so the CPU harness never pays
    the dense k=5 parity matrix's multi-second CSE pass."""
    from ..ec.plugins.lrc import ErasureCodeLrc
    from ..ec.plugins.pmsr import ErasureCodePmsr
    out: list[tuple[str, np.ndarray]] = []
    if "lrc" in codes:
        lrc = ErasureCodeLrc(device=device)
        lrc.init({"k": "8", "m": "4", "l": "3"})
        out.append(("lrc_k8m4l3_parity", lrc.parity_matrix))
        # single-loss local repair: the lost chunk over its group
        lost = 0
        src = tuple(sorted(
            lrc.minimum_to_decode({lost},
                                  set(range(16)) - {lost}).keys()))
        out.append(("lrc_k8m4l3_local_repair",
                    lrc.repair_matrix(src, (lost,))))
    if "pmsr" in codes:
        pk, pm = (3, 2) if smoke else (5, 4)
        pmsr = ErasureCodePmsr(device=device)
        pmsr.init({"k": str(pk), "m": str(pm)})
        out.append((f"pmsr_k{pk}m{pm}_parity", pmsr.parity_matrix))
        helpers = tuple(range(1, 1 + pmsr.d))
        out.append((f"pmsr_k{pk}m{pm}_aggregate",
                    pmsr.aggregate_matrix(0, helpers)))
    return out


def _timed(fn, iters: int, device: torch.device) -> tuple[float, torch.Tensor]:
    """Mean seconds per call after a warm-up, and the last output."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def sweep_matrix_engines(mat: np.ndarray, batch: int, lane: int,
                         device: torch.device, iters: int = 8,
                         tag: str = "") -> dict:
    """Dense vs scheduled on one (matrix, batch, lane) shape: time both
    engines on the same device-resident batch, hold both against the host
    oracle, and return the winner record the cost model consumes.  A
    mismatch raises."""
    from ..gf import gf_matmul
    from ..ops import gf2kernels as G
    from ..ops import xor_schedule as XS

    mat = np.ascontiguousarray(mat, np.uint8)
    m, k = mat.shape
    rng = np.random.default_rng(0)
    xd = stage_batch(rng, batch, k, lane, device)
    ncheck = min(512, lane)
    want = gf_matmul(mat, xd[0, :, :ncheck].cpu().numpy())

    os.environ["CEPH_TPU_XOR_SCHED"] = "0"
    try:
        dt_dense, out = _timed(lambda: G.gf_matmul_batch_device(mat, xd),
                               iters, device)
    finally:
        os.environ.pop("CEPH_TPU_XOR_SCHED", None)
    if not np.array_equal(out[0, :, :ncheck].cpu().numpy(), want):
        raise RuntimeError(f"engine sweep {tag}: dense output differs "
                           f"from the host oracle")
    sched = XS.schedule_for(G.bitmatrix_i8(mat))
    dt_sched, out = _timed(
        lambda: XS.sched_matmul_batch_device(sched, mat, xd), iters, device)
    if not np.array_equal(out[0, :, :ncheck].cpu().numpy(), want):
        raise RuntimeError(f"engine sweep {tag}: scheduled output differs "
                           f"from the host oracle")
    gibps = lambda dt: batch * k * lane / dt / 2**30  # noqa: E731
    rec = {
        "engine": "scheduled" if dt_sched < dt_dense else "dense",
        "dense_gibps": round(gibps(dt_dense), 3),
        "sched_gibps": round(gibps(dt_sched), 3),
        "sched_terms": sched.n_terms,
        "naive_terms": sched.naive_terms,
        "reduction_pct": round(100 * sched.reduction, 1),
    }
    log(f"engine sweep {tag or f'{k},{m}'} batch={batch} "
        f"lane={lane}: dense={rec['dense_gibps']} GiB/s "
        f"sched={rec['sched_gibps']} GiB/s -> {rec['engine']} "
        f"(xor terms {sched.n_terms}/{sched.naive_terms})")
    return rec


def _write_tuned(path: str, update: dict) -> None:
    try:
        with open(path) as f:
            tuned = json.load(f)
    except (OSError, ValueError):
        tuned = {}
    for key, val in update.items():
        if isinstance(val, dict) and isinstance(tuned.get(key), dict):
            tuned[key].update(val)
        else:
            tuned[key] = val
    with open(path, "w") as f:
        json.dump(tuned, f, indent=2, sort_keys=True)
    log(f"wrote {path}: {sorted(update)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--batch", type=int, default=256,
                    help="stripes per launch (rounded to a multiple of 8)")
    ap.add_argument("--chunk", type=int, default=1 << 17)
    ap.add_argument("--write", action="store_true",
                    help="persist the winners to the tuned file")
    ap.add_argument("--out", default=None,
                    help="tuned-file path (default: the live "
                         "ceph_tpu_torch/ops/gf2_tuned.json)")
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="CPU harness mode: tiny shapes on the CPU")
    ap.add_argument("--codes", default="",
                    help="comma list of recovery-code matrix families "
                         "to sweep into xor_sched entries (lrc,pmsr): "
                         "local-parity / repair / fragment-aggregate "
                         "matrices keyed by their matrix dims")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu_smoke else None)
    log(f"device={device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    if args.cpu_smoke:
        args.batch = min(args.batch, 8)
        args.chunk = min(args.chunk, 4096)
    args.batch = max(8, (args.batch // 8) * 8)

    iters = 2 if args.cpu_smoke else 8
    engines = sweep_engines(args.k, args.m, args.batch, args.chunk, device,
                            iters=iters)
    code_recs: dict[str, dict] = {}
    codes = [c for c in args.codes.split(",") if c]
    for tag, mat in code_matrices(codes, device, smoke=args.cpu_smoke):
        r, c = mat.shape
        # lane at the granularity the runtime launches with: the flat
        # sub-chunk dialect reshapes chunks, so tune at a sub-lane
        lane = max(512, min(args.chunk, 4096)) if args.cpu_smoke \
            else args.chunk
        rec = sweep_matrix_engines(mat, args.batch, lane, device,
                                   iters=iters, tag=tag)
        rec["tag"] = tag
        code_recs[f"{c},{r}"] = rec
    report = {"k": args.k, "m": args.m, "chunk": args.chunk,
              "device": str(device), "xor_sched": engines}
    if code_recs:
        report["xor_sched_codes"] = code_recs
    print(json.dumps(report, indent=2))
    if args.write:
        from ..ops.gf2kernels import _TUNED_PATH
        update = {"xor_sched": {
            f"{args.k},{args.m},{args.chunk}": engines,
            f"{args.k},{args.m}": engines,
            **code_recs,
        }}
        _write_tuned(args.out or _TUNED_PATH, update)
    return 0


if __name__ == "__main__":
    sys.exit(main())
