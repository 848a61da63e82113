"""Erasure-code micro-benchmark with ceph_erasure_code_benchmark's contract.

The plugin is selected by name and profile only; an encode loop over a fixed
buffer, or a decode loop with random or exhaustive erasures and byte-for-byte
verification; one tab-separated output line "<seconds>\\t<total KiB>".

``--batch B`` runs the batched device pipeline: B stripes per launch with the
data resident on the codec's device.  Timing ends with a device synchronise,
since a CUDA launch returns before the card has finished.

    python -m ceph_tpu_torch.tools.ec_bench --plugin cuda -P k=8 -P m=3 \\
        --batch 1024 --size 1048576
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np
import torch

from ..ec import registry


def parse_profile(args) -> dict:
    profile = {}
    for kv in args.parameter or []:
        k, _, v = kv.partition("=")
        profile[k] = v
    profile.setdefault("k", str(args.k))
    profile.setdefault("m", str(args.m))
    return profile


def _block(out) -> None:
    """Wait until ``out`` is computed: a CUDA tensor waits for its device."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def run_encode(codec, size: int, iterations: int, batch: int) -> tuple[float, int]:
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    if batch > 1:
        chunk = codec.get_chunk_size(size)
        rng = np.random.default_rng(0)
        data = torch.from_numpy(
            rng.integers(0, 256, size=(batch, k, chunk), dtype=np.uint8)
        ).to(codec.device)
        out = codec.encode_batch(data)      # warm-up: first-use build + check
        _block(out)
        begin = time.perf_counter()
        for _ in range(iterations):
            out = codec.encode_batch(data)
        _block(out)
        elapsed = time.perf_counter() - begin
        return elapsed, batch * k * chunk * iterations // 1024
    want = set(range(n))
    buf = b"X" * size
    begin = time.perf_counter()
    for _ in range(iterations):
        codec.encode(want, buf)
    elapsed = time.perf_counter() - begin
    return elapsed, size * iterations // 1024


def run_decode(codec, size: int, iterations: int, erasures: int,
               exhaustive: bool, verify: bool) -> tuple[float, int]:
    n = codec.get_chunk_count()
    rng = np.random.default_rng(42)
    raw = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(n)), raw)
    patterns = (list(itertools.combinations(range(n), erasures))
                if exhaustive else None)
    begin = time.perf_counter()
    for i in range(iterations):
        if patterns is not None:
            erased = list(patterns[i % len(patterns)])
        else:
            erased = sorted(rng.choice(n, size=erasures, replace=False))
        avail = {j: encoded[j] for j in range(n) if j not in erased}
        decoded = codec.decode(set(range(n)), avail)
        if verify:
            for e in erased:
                if not np.array_equal(decoded[e], encoded[e]):
                    raise SystemExit(
                        f"byte parity FAILED for chunk {e} erasures {erased}")
    elapsed = time.perf_counter() - begin
    return elapsed, size * iterations // 1024


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_bench")
    p.add_argument("-P", "--parameter", action="append",
                   help="profile k=v (repeatable)")
    p.add_argument("--plugin", default="cuda")
    p.add_argument("-k", type=int, default=8)
    p.add_argument("-m", type=int, default=3)
    p.add_argument("-s", "--size", type=int, default=1 << 20,
                   help="object size per op (bytes)")
    p.add_argument("-i", "--iterations", type=int, default=10)
    p.add_argument("-w", "--workload", choices=("encode", "decode"),
                   default="encode")
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--erasures-generation", choices=("random", "exhaustive"),
                   default="random")
    p.add_argument("--batch", type=int, default=1,
                   help="stripes per device launch (batched pipeline)")
    p.add_argument("--verify", action="store_true")
    args = p.parse_args(argv)

    codec = registry().factory(args.plugin, parse_profile(args))
    if args.workload == "encode":
        elapsed, kib = run_encode(codec, args.size, args.iterations,
                                  args.batch)
    else:
        exhaustive = args.erasures_generation == "exhaustive"
        elapsed, kib = run_decode(codec, args.size, args.iterations,
                                  args.erasures, exhaustive,
                                  args.verify or exhaustive)
    print(f"{elapsed:.6f}\t{kib}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
