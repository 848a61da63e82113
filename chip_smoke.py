#!/usr/bin/env python3
"""Drive the port's erasure-code main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

 1. the card's name and power limit; build every kernel in
    ``ceph_tpu_torch/csrc`` with nvcc (one process per source, all at once);
 2. each kernel against its plain PyTorch version and the host GF(2^8)
    oracle on seeded inputs at small shapes, byte-exact;
 3. the main path at full width: the ``cuda`` plugin at RS k=8,m=3 encodes
    (1024, 8, 131072) bytes (1 MiB stripes, 1 GiB) with ``encode_batch``,
    recovers erasures [1, 9] with ``decode_batch``, then encodes and decodes
    one 1 MiB object per op; launch counts are read over this run alone;
 4. Cauchy k=10,m=4 2-erasure decode on (128, 10, 131072);
 5. a ``kernels`` JSON line: per kernel its launches on the main path, its
    time at the headline shape, its bound, its plain version's time and its
    largest difference from the plain version over the headline input;
 6. the result line {"ok": true, "device": {...}}.

It needs one card; without one it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
GiB = float(1 << 30)
# (stripes, k, m, chunk bytes): BASELINE.json configs 2 and 3, 1 MiB stripes
MAIN = (1024, 8, 3, 131072)
CAUCHY = (128, 10, 4, 131072)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
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


def host_ms(fn, iters: int = 10) -> float:
    """Mean host-clock time of a call that ends on the host (numpy out)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def host_stripes(matrix, x: torch.Tensor, idx) -> list[np.ndarray]:
    from ceph_tpu_torch.gf import gf_matmul
    return [gf_matmul(matrix, x[int(i)].cpu().numpy()) for i in idx]


def phase_build() -> None:
    from ceph_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    sources = _build.all_sources()
    t0 = time.perf_counter()
    reports = _build.build(sources)
    dt = time.perf_counter() - t0
    for name, report in reports.items():
        regs = [int(w) for line in report.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(w) for line in report.splitlines()
                     for w, nxt in zip(line.split(), line.split()[1:])
                     if nxt == "bytes" and "spill" in line)
        log(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes of stack and spills")
    log(f"build: {', '.join(sources)} in {dt:.2f} s "
        f"({len(reports)} compiled, sm_90a)")


def phase_kernels(dev: torch.device) -> dict:
    """Small seeded shapes: kernel == plain == host oracle, byte for byte."""
    from ceph_tpu_torch.gf import (gen_rs_matrix, gen_cauchy1_matrix,
                                   build_decode_matrix)
    from ceph_tpu_torch.ops import gf2kernels as gk

    rng = np.random.default_rng(SEED)
    cases = []                                  # (label, matrix, B, L)
    for k, m, n in [(8, 3, 512), (10, 4, 96), (4, 2, 8192), (8, 3, 1000)]:
        mat = gen_rs_matrix(k + m, k)[k:]
        cases.append((f"rs{k}/{m} flat n={n}", mat, 1, n))
        cases.append((f"rs{k}/{m} B=8 L={n}", mat, 8, n))
    gen83 = gen_rs_matrix(11, 8)
    cases.append(("rs8/3 ragged", gen83[8:], 3, 1001))
    cases.append(("rs8/3 decode[1,9]", build_decode_matrix(gen83, 8, [1, 9])[0],
                  4, 512))
    cases.append(("rs8/3 odd B", gen83[8:], 5, 256))
    cauchy = gen_cauchy1_matrix(14, 10)
    cases.append(("cauchy10/4 decode[2,11]",
                  build_decode_matrix(cauchy, 10, [2, 11])[0], 2, 256))
    cases.append(("rs5/3 g=1 k=5", gen_rs_matrix(8, 5)[5:], 2, 128))

    err = {"gf2_matmul_popc": 0, "gf2_matmul_mma": 0}
    checked = {"gf2_matmul_popc": 0, "gf2_matmul_mma": 0}
    for label, mat, b, l in cases:
        mat = np.ascontiguousarray(mat, np.uint8)
        k = mat.shape[1]
        x = torch.from_numpy(
            rng.integers(0, 256, (b, k, l), dtype=np.uint8)).to(dev)
        want = np.stack(host_stripes(mat, x, range(b)))
        runs = [("gf2_matmul_popc", lambda: gk.gf2_matmul_popc(mat, x),
                 lambda: gk.gf2_matmul_plain(
                     torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev), x))]
        g = gk.pick_group(k, b)
        if l % gk.MMA_COLS == 0 and 8 * k * g <= 128:
            runs.append(("gf2_matmul_mma", lambda: gk.gf2_matmul_mma(mat, x, g),
                         lambda: gk.gf2_matmul_grouped_plain(
                             torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev),
                             x, g)))
        for name, kernel, plain in runs:
            got = kernel()
            ref = plain()
            torch.cuda.synchronize()
            diff = int((got.int() - ref.int()).abs().max())
            err[name] = max(err[name], diff)
            if diff or not np.array_equal(got.cpu().numpy(), want):
                raise RuntimeError(f"{name} differs on {label}: max |kernel - "
                                   f"plain| = {diff}")
            checked[name] += 1
    log(f"kernels vs plain and host oracle: {checked} shapes byte-exact")
    return err


def phase_main_path(dev: torch.device) -> tuple[dict, dict]:
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ops.gf2kernels import LAUNCHES

    b, k, m, l = MAIN
    codec = registry().factory("cuda", {"k": str(k), "m": str(m),
                                        "technique": "reed_sol_van"})
    isa = registry().factory("isa", {"k": str(k), "m": str(m),
                                     "technique": "reed_sol_van"})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    erasures = [1, 9]
    decode_index = codec.decode_entry(erasures)[1]
    obj = np.random.default_rng(SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    torch.cuda.synchronize()

    for name in LAUNCHES:
        LAUNCHES[name] = 0
    parity = codec.encode_batch(data)
    full = torch.cat([data, parity], dim=1)
    survivors = full[:, decode_index].contiguous()
    lost = full[:, erasures].contiguous()
    del full
    recovered = codec.decode_batch(erasures, survivors)
    enc = codec.encode(set(range(k + m)), obj)
    dec = codec.decode(set(range(k + m)),
                       {i: enc[i] for i in range(k + m) if i not in erasures})
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    if parity.shape != (b, m, l) or recovered.shape != (b, 2, l):
        raise RuntimeError(f"bad shapes {parity.shape} {recovered.shape}")
    if not torch.equal(recovered, lost):
        raise RuntimeError("decode_batch: recovered chunks differ")
    pick = np.random.default_rng(SEED + 1).choice(b, 8, replace=False)
    for i, want in zip(pick, host_stripes(codec.encode_matrix[k:], data, pick)):
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"encode_batch: stripe {i} differs from host")
    enc_isa = isa.encode(set(range(k + m)), obj)
    for i in range(k + m):
        if not np.array_equal(enc[i], enc_isa[i]):
            raise RuntimeError(f"per-op encode: chunk {i} differs from isa")
    for e in erasures:
        if not np.array_equal(dec[e], enc_isa[e]):
            raise RuntimeError(f"per-op decode: chunk {e} differs from isa")
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"{name} was not launched on the main path")

    enc_ms = time_ms(lambda: codec.encode_batch(data))
    dec_ms = time_ms(lambda: codec.decode_batch(erasures, survivors))
    avail = {i: enc[i] for i in range(k + m) if i not in erasures}
    op_enc_ms = host_ms(lambda: codec.encode(set(range(k + m)), obj))
    op_dec_ms = host_ms(lambda: codec.decode(set(range(k + m)), avail))
    log(f"main path rs8/3 ({b}, {k}, {l}): encode {b * k * l / GiB / enc_ms * 1e3:.2f} "
        f"GiB/s ({enc_ms:.3f} ms), decode[1,9] "
        f"{b * k * l / GiB / dec_ms * 1e3:.2f} GiB/s ({dec_ms:.3f} ms); "
        f"per-op 1 MiB encode {op_enc_ms:.3f} ms, decode {op_dec_ms:.3f} ms "
        f"(host clock); recovered == lost, 8 stripes == host, per-op 1 MiB "
        f"== isa; launches {launches}")
    return launches, {"data": data, "matrix": codec.encode_matrix[k:]}


def phase_cauchy(dev: torch.device) -> None:
    from ceph_tpu_torch.ec import registry

    b, k, m, l = CAUCHY
    codec = registry().factory("cuda", {"k": str(k), "m": str(m),
                                        "technique": "cauchy"})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    parity = codec.encode_batch(data)
    erasures = [2, 11]
    matrix, decode_index = codec.decode_entry(erasures)
    full = torch.cat([data, parity], dim=1)
    survivors = full[:, decode_index].contiguous()
    lost = full[:, erasures].contiguous()
    del full
    recovered = codec.decode_batch(erasures, survivors)
    torch.cuda.synchronize()
    if not torch.equal(recovered, lost):
        raise RuntimeError("cauchy decode_batch: recovered chunks differ")
    pick = np.random.default_rng(SEED + 3).choice(b, 4, replace=False)
    for i, want in zip(pick, host_stripes(codec.encode_matrix[k:], data, pick)):
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"cauchy encode_batch: stripe {i} differs")
    dec_ms = time_ms(lambda: codec.decode_batch(erasures, survivors))
    log(f"cauchy10/4 ({b}, {k}, {l}): decode[2,11] "
        f"{b * k * l / GiB / dec_ms * 1e3:.2f} GiB/s ({dec_ms:.3f} ms), "
        f"recovered == lost, 4 stripes == host")


def phase_kernel_line(main: dict, launches: dict, small_err: dict) -> dict:
    """Each kernel at the headline shape: time, bound, plain time, error."""
    from ceph_tpu_torch.ops import gf2kernels as gk

    data, mat = main["data"], np.ascontiguousarray(main["matrix"], np.uint8)
    b, k, l = data.shape
    r = mat.shape[0]
    g = gk.pick_group(k, b)
    dev = data.device
    w_flat = torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev)
    w_group = torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev)
    kernels = {
        "gf2_matmul_popc": (lambda: gk.gf2_matmul_popc(mat, data),
                            lambda x: gk.gf2_matmul_plain(w_flat, x),
                            "ceph_tpu/ops/gf2kernels.py:142, "
                            "ceph_tpu/ops/gf2kernels.py:165"),
        "gf2_matmul_mma": (lambda: gk.gf2_matmul_mma(mat, data, g),
                           lambda x: gk.gf2_matmul_grouped_plain(w_group, x, g),
                           "ceph_tpu/ops/gf2kernels.py:317"),
    }
    nbytes = data.numel() + b * r * l + 64 * r * k
    ops = 2 * (8 * r) * (8 * k) * b * l
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    rows = []
    slice_b = 64                      # plain versions expand 32x: run in slices
    for name, (kernel, plain, replaces) in kernels.items():
        out = kernel()
        ms = time_ms(kernel)
        plain(data[:slice_b])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        refs = [plain(data[i:i + slice_b]) for i in range(0, b, slice_b)]
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max(int((out[i:i + slice_b].int() - ref.int()).abs().max())
                  for i, ref in zip(range(0, b, slice_b), refs))
        del refs, out
        rows.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_matmul.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(err, small_err[name]),
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a GF(2^8) "
                            "matrix product",
            "shape": [b, k, l], "r": r,
        })
        if err:
            raise RuntimeError(f"{name} differs from its plain version at "
                               f"the headline shape: max {err}")
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    small_err = phase_kernels(dev)
    launches, main_inputs = phase_main_path(dev)
    phase_cauchy(dev)
    line = phase_kernel_line(main_inputs, launches, small_err)
    log(json.dumps(line))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / GiB:.2f} "
        f"GiB, total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
