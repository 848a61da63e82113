#!/usr/bin/env python3
"""Drive the port's erasure-code main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

 1. the card's name and power limit; compile the XOR schedules of every
    matrix the run uses, then build every kernel with nvcc, one process per
    source, all at once: ``ceph_tpu_torch/csrc/*.cu`` and one generated K3
    source per schedule digest (ptxas registers, spills and nvcc seconds
    per digest);
 2. K1/K2 against their plain PyTorch versions and the host GF(2^8) oracle
    on seeded inputs at small shapes, byte-exact;
 3. K3 likewise, on the schedules of RS, LRC and PMSR matrices and of
    matrices with a unit, a zero and a repeated row, with ragged L, odd B
    and a misaligned base;
 4. the RS main path at full width: the ``cuda`` plugin at RS k=8,m=3
    encodes (1024, 8, 131072) bytes (1 MiB stripes, 1 GiB) with
    ``encode_batch``, recovers erasures [1, 9] with ``decode_batch``, then
    encodes and decodes one 1 MiB object per op; it routes dense (K1/K2);
 5. Cauchy k=10,m=4 2-erasure decode on (128, 10, 131072);
 6. LRC k=8,m=4,l=3 on (1024, 8, 131072): ``encode_batch`` and the local
    repair of chunk 0 from (1, 2, 3), once through the scheduled engine
    (``CEPH_TPU_XOR_SCHED=1``, K3) and once dense (``=0``, K2);
 7. PMSR k=5,m=4 on (1024, 5, 131072) (sub-lane 32768): encode and a
    2-erasure decode through K3 and dense (K1);
 8. the engine sweep ``ceph_tpu_torch.tools.ec_autotune --codes lrc,pmsr``
    at batch 1024, chunk 131072, and its winners;
 9. a ``kernels`` JSON line: per kernel its launches on its paths (phase 4
    for K1/K2, phases 6-7 for K3), its time at its headline shape, its
    bound, its plain version's time and its largest difference from the
    plain version;
10. the result line {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it is driven and read
just after; a kernel of the path that did not launch fails the run.

It needs one card; without one it exits with code 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
INT32_OPS_PER_CLOCK = 64 * 132   # H100 SXM: 64 INT32 lanes per SM, 132 SMs
GiB = float(1 << 30)
# (stripes, k, m, chunk bytes): BASELINE.json configs 2 and 3, 1 MiB stripes
MAIN = (1024, 8, 3, 131072)
CAUCHY = (128, 10, 4, 131072)
# the recovery codes at full width: (stripes, chunk bytes) and profile
LRC = (1024, 131072, {"k": "8", "m": "4", "l": "3"})
PMSR = (1024, 131072, {"k": "5", "m": "4"})
PMSR_LOST = (1, 6)               # a data chunk and a coding chunk
# the engine sweep's (batch, chunk); it writes a table in the build
# directory, not the live one
SWEEP = (1024, 131072)


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


def ptxas_summary(report: str) -> str:
    """Registers, stack frame and spill bytes from an nvcc -Xptxas -v log."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]

    def total(what: str) -> int:
        return sum(int(n) for n in re.findall(rf"(\d+) bytes {what}", report))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{total('stack frame')} bytes stack, {total('spill stores')}/"
            f"{total('spill loads')} bytes spill stores/loads")


@contextlib.contextmanager
def xor_sched_env(value: str | None):
    """CEPH_TPU_XOR_SCHED for the block: "1" scheduled, "0" dense, None the
    cost model's own choice (dense on the card)."""
    old = os.environ.pop("CEPH_TPU_XOR_SCHED", None)
    if value is not None:
        os.environ["CEPH_TPU_XOR_SCHED"] = value
    try:
        yield
    finally:
        os.environ.pop("CEPH_TPU_XOR_SCHED", None)
        if old is not None:
            os.environ["CEPH_TPU_XOR_SCHED"] = old


def path_matrices() -> dict:
    """Every GF(2^8) matrix whose schedule this run launches, by label."""
    from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    from ceph_tpu_torch.gf import build_decode_matrix, gen_rs_matrix

    rs = gen_rs_matrix(11, 8)
    lrc = ErasureCodeLrc()
    lrc.init(dict(LRC[2]))
    pmsr3 = ErasureCodePmsr()
    pmsr3.init({"k": "3", "m": "2"})
    pmsr5 = ErasureCodePmsr()
    pmsr5.init(dict(PMSR[2]))
    n5 = pmsr5.get_chunk_count()
    plan = pmsr5.decode_plan(set(PMSR_LOST), set(range(n5)) - set(PMSR_LOST))
    return {
        "rs8/3 parity": rs[8:],
        "rs8/3 decode[1,9]": build_decode_matrix(rs, 8, [1, 9])[0],
        "lrc8/4/3 parity": lrc.parity_matrix,
        "lrc8/4/3 local repair": lrc.repair_matrix((1, 2, 3), (0,)),
        "pmsr3/2 parity": pmsr3.parity_matrix,
        "pmsr3/2 aggregate": pmsr3.aggregate_matrix(0, (1, 2, 3, 4)),
        "unit, zero, repeated rows": np.array(
            [[1, 0, 0, 0], [0, 0, 0, 0], [5, 7, 0, 2], [5, 7, 0, 2],
             [0, 0, 1, 0]], np.uint8),
        "pmsr5/4 parity": pmsr5.parity_matrix,
        f"pmsr5/4 decode{list(PMSR_LOST)}": pmsr5.repair_matrix(*plan),
        "pmsr5/4 aggregate": pmsr5.aggregate_matrix(
            0, tuple(range(1, 1 + pmsr5.d))),
    }


def phase_build() -> dict:
    """Compile the schedules, build every kernel; returns label -> (matrix,
    schedule, nvcc seconds)."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    t0 = time.perf_counter()
    mats = path_matrices()
    scheds = {label: xs.schedule_for(gk.bitmatrix_i8(mat))
              for label, mat in mats.items()}
    log(f"schedules: {len(scheds)} compiled in "
        f"{time.perf_counter() - t0:.2f} s (host CSE)")
    sources = _build.all_sources()
    k3 = {label: xs.k3_source(sched) for label, sched in scheds.items()}
    t0 = time.perf_counter()
    reports = _build.build(sources + sorted(set(k3.values())))
    dt = time.perf_counter() - t0
    for name in sources:
        if name in reports:
            log(f"ptxas {name}: {ptxas_summary(reports[name].log)}")
    out = {}
    for label, name in k3.items():
        sched, built = scheds[label], reports.get(name)
        secs = built.seconds if built else None
        out[label] = (mats[label], sched, secs)
        log(f"K3 {label}: {sched.n_out}x{sched.n_in}, {sched.n_terms} XORs "
            f"(naive {sched.naive_terms}), peak {sched.peak_registers} "
            f"temporaries; "
            + (f"ptxas {ptxas_summary(built.log)}, nvcc {secs:.2f} s"
               if built else "already built"))
    log(f"build: {len(sources)} sources + {len(set(k3.values()))} K3 digests "
        f"in {dt:.2f} s ({len(reports)} compiled, sm_90a, all at once)")
    return out


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


def phase_k3_small(dev: torch.device, built: dict) -> int:
    """K3 == plain == host oracle, byte for byte, on small seeded shapes."""
    from ceph_tpu_torch.gf import gf_matmul
    from ceph_tpu_torch.ops import xor_schedule as xs

    pmsr_dec = next(label for label in built if "pmsr5/4 decode" in label)
    cases = [   # (label, B, L, misaligned base)
        ("rs8/3 parity", 2, 512, False), ("rs8/3 parity", 3, 1001, False),
        ("rs8/3 parity", 2, 512, True),
        ("rs8/3 decode[1,9]", 4, 512, False),
        ("lrc8/4/3 parity", 5, 4096, False),
        ("lrc8/4/3 local repair", 3, 1000, False),
        ("pmsr3/2 parity", 2, 777, False), ("pmsr3/2 aggregate", 1, 64, False),
        ("unit, zero, repeated rows", 7, 100, False),
        ("pmsr5/4 parity", 2, 2048, False), (pmsr_dec, 2, 1024, False),
        ("pmsr5/4 aggregate", 3, 96, False),
    ]
    rng = np.random.default_rng(SEED + 4)
    err = 0
    for label, b, l, misaligned in cases:
        mat, sched, _ = built[label]
        k = mat.shape[1]
        host = rng.integers(0, 256, (b, k, l), dtype=np.uint8)
        if misaligned:
            buf = torch.empty(b * k * l + 1, dtype=torch.uint8, device=dev)
            x = buf[1:].view(b, k, l)
            x.copy_(torch.from_numpy(host))
        else:
            x = torch.from_numpy(host).to(dev)
        got = xs.xor_sched(sched, x)
        ref = xs.apply_bits_plain(sched, x)
        torch.cuda.synchronize()
        diff = int((got.int() - ref.int()).abs().max())
        err = max(err, diff)
        want = np.stack([gf_matmul(mat, host[i]) for i in range(b)])
        if diff or not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"xor_sched differs on {label} B={b} L={l}: "
                               f"max |kernel - plain| = {diff}")
    log(f"K3 xor_sched vs plain and host oracle: {len(cases)} shapes over "
        f"{len({c[0] for c in cases})} digests byte-exact (ragged L, odd B, "
        f"misaligned base included)")
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
    for name in ("gf2_matmul_popc", "gf2_matmul_mma"):
        if launches[name] < 1:
            raise RuntimeError(f"{name} was not launched on the main path")
    if launches["xor_sched"]:
        raise RuntimeError("the RS main path left the dense kernels")

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


def gibps(nbytes: int, ms: float) -> float:
    return nbytes / GiB / ms * 1e3


def phase_linear(dev: torch.device, plugin: str, spec: tuple, lost: tuple,
                 seed: int) -> dict:
    """A recovery code at full width through both engines: encode_batch and
    the decode_batch that decode_plan gives for ``lost``, once scheduled (K3)
    and once dense; launch counts over this drive alone."""
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.gf import gf_matmul
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs

    b, l, profile = spec
    codec = registry().factory(plugin, dict(profile))
    k, m, n, a = codec.k, codec.m, codec.get_chunk_count(), codec.alpha
    src, lost = codec.decode_plan(set(lost), set(range(n)) - set(lost))
    extra = codec.pack_decode_extra(src, lost)
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    torch.cuda.synchronize()

    def by_position(parity):
        pos = {codec.chunk_index(i): data[:, i] for i in range(k)}
        pos.update({p: parity[:, r]
                    for r, p in enumerate(codec.coding_positions)})
        return pos

    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    with xor_sched_env("1"):
        parity = codec.encode_batch(data)
        pos = by_position(parity)
        survivors = torch.stack([pos[p] for p in src], dim=1)
        recovered = codec.decode_batch(extra, survivors)
    with xor_sched_env("0"):
        parity_dense = codec.encode_batch(data)
        recovered_dense = codec.decode_batch(extra, survivors)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)

    tag = f"{plugin}{'/'.join(profile.values())}"
    if parity.shape != (b, m, l) or recovered.shape != (b, len(lost), l):
        raise RuntimeError(f"{tag}: bad shapes {parity.shape} "
                           f"{recovered.shape}")
    if not torch.equal(parity, parity_dense):
        raise RuntimeError(f"{tag}: scheduled and dense encode differ")
    if not torch.equal(recovered, recovered_dense):
        raise RuntimeError(f"{tag}: scheduled and dense decode differ")
    if not torch.equal(recovered, torch.stack([pos[p] for p in lost], 1)):
        raise RuntimeError(f"{tag}: recovered chunks differ from the lost")
    del parity_dense, recovered_dense
    pick = np.random.default_rng(seed + 1).choice(b, 8, replace=False)
    for i in pick:
        sub = data[int(i)].cpu().numpy().reshape(k * a, l // a)
        want = gf_matmul(codec.parity_matrix, sub).reshape(m, l)
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"{tag}: encode stripe {i} differs from host")
    sched = xs.schedule_for(gk.bitmatrix_i8(codec.parity_matrix))
    plain = xs.apply_bits_plain(sched, data[:4].reshape(4, k * a, l // a))
    if not torch.equal(plain.reshape(4, m, l), parity[:4]):
        raise RuntimeError(f"{tag}: K3 encode differs from its plain version")
    if launches["xor_sched"] < 2:
        raise RuntimeError(f"{tag}: xor_sched was not launched on the path")
    dense = launches["gf2_matmul_popc"] + launches["gf2_matmul_mma"]
    if dense < 2:
        raise RuntimeError(f"{tag}: the dense kernels were not launched")

    times = {}
    for engine in ("1", "0"):
        with xor_sched_env(engine):
            times[engine] = (
                time_ms(lambda: codec.encode_batch(data)),
                time_ms(lambda: codec.decode_batch(extra, survivors)))
    dense_name = "K2" if launches["gf2_matmul_mma"] else "K1"
    enc_bytes, dec_bytes = data.numel(), survivors.numel()
    log(f"{tag} ({b}, {k}, {l}), sub-lane {l // a}: encode K3 "
        f"{gibps(enc_bytes, times['1'][0]):.2f} GiB/s ({times['1'][0]:.3f} "
        f"ms) vs {dense_name} {gibps(enc_bytes, times['0'][0]):.2f} GiB/s "
        f"({times['0'][0]:.3f} ms); decode {list(src)} -> {list(lost)} "
        f"{tuple(survivors.shape)} K3 {gibps(dec_bytes, times['1'][1]):.2f} "
        f"GiB/s ({times['1'][1]:.3f} ms) vs {dense_name} "
        f"{gibps(dec_bytes, times['0'][1]):.2f} GiB/s ({times['0'][1]:.3f} "
        f"ms) [GiB/s of input read]; scheduled == dense, recovered == lost, "
        f"8 stripes == host, 4 stripes == plain; launches {launches}")
    return {"launches": launches, "data": data, "sched": sched,
            "matrix": codec.parity_matrix}


def phase_autotune() -> None:
    """The port's engine sweep on the card, written to a smoke table."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.tools import ec_autotune
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    table = _build.BUILD_DIR / "gf2_tuned.smoke.json"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ec_autotune.main(["--codes", "lrc,pmsr", "--batch",
                               str(SWEEP[0]), "--chunk", str(SWEEP[1]),
                               "--write", "--out", str(table)])
    if rc:
        raise RuntimeError(f"ec_autotune exited {rc}:\n{err.getvalue()}")
    report = json.loads(out.getvalue())
    rows = {"rs8/3_parity": report["xor_sched"]}
    rows.update({r["tag"]: r for r in report["xor_sched_codes"].values()})
    log(f"engine sweep (ec_autotune, batch {SWEEP[0]}, chunk {SWEEP[1]}): "
        + "; ".join(
        f"{tag} dense {r['dense_gibps']} vs scheduled {r['sched_gibps']} "
        f"GiB/s ({r['sched_terms']}/{r['naive_terms']} XORs) -> {r['engine']}"
        for tag, r in rows.items()) + f"; written to {table.name}")


def sm_clock_mhz_under(fn, launches: int = 1500) -> tuple[float, str]:
    """The SM clock nvidia-smi reads while ``fn``'s launches run."""
    for _ in range(launches):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    now, peak = (v.strip() for v in smi.stdout.splitlines()[0].split(","))
    return (float(now), "clocks.sm under load") if now.isdigit() \
        else (float(peak), "clocks.max.sm")


def plain_in_slices(plain, data: torch.Tensor, out: torch.Tensor,
                    slice_b: int = 64) -> tuple[float, int]:
    """A plain version over the whole input in slices of stripes (a full-size
    bit-plane tensor would not fit): its device time, and its largest
    difference from the kernel's ``out``."""
    plain(data[:slice_b])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    refs = [plain(data[i:i + slice_b]) for i in range(0, data.shape[0], slice_b)]
    end.record()
    end.synchronize()
    err = max(int((out[i:i + slice_b].int() - ref.int()).abs().max())
              for i, ref in zip(range(0, data.shape[0], slice_b), refs))
    return start.elapsed_time(end), err


def phase_kernel_line(main: dict, launches: dict, small_err: dict,
                      lrc: dict, pmsr: dict, k3_small_err: int) -> dict:
    """Each kernel at its headline shape: time, bound, plain time, error."""
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs

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
    for name, (kernel, plain, replaces) in kernels.items():
        out = kernel()
        ms = time_ms(kernel)
        plain_ms, err = plain_in_slices(plain, data, out)
        del out
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

    # K3 at LRC k=8,m=4,l=3 encode: n_terms XORs per 32 byte columns
    data, sched = lrc["data"], lrc["sched"]
    b, k, l = data.shape
    r = sched.n_out // 8
    kernel = lambda: xs.xor_sched(sched, data)  # noqa: E731
    out = kernel()
    ms = time_ms(kernel)
    mhz, clock_source = sm_clock_mhz_under(kernel)
    plain_ms, err = plain_in_slices(
        lambda x: xs.apply_bits_plain(sched, x), data, out)
    del out
    t_bytes = (b * k * l + b * r * l) / HBM_BYTES_PER_S * 1e3
    t_ops = sched.n_terms * b * -(-l // 32) / (INT32_OPS_PER_CLOCK * mhz * 1e6) * 1e3
    rows.append({
        "name": "xor_sched", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/xor_sched.cuh",
        "generator": "ceph_tpu_torch/ops/xor_sched_codegen.py",
        "replaces": "ceph_tpu/ops/xor_schedule.py:529",
        "launches": lrc["launches"]["xor_sched"] + pmsr["launches"]["xor_sched"],
        "launches_by_path": {"lrc": lrc["launches"]["xor_sched"],
                             "pmsr": pmsr["launches"]["xor_sched"]},
        "max_abs_err": max(err, k3_small_err),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a GF(2) XOR schedule",
        "shape": [b, k, l], "r": r, "n_terms": sched.n_terms,
        "sm_clock_mhz": mhz, "clock_source": clock_source,
    })
    if err:
        raise RuntimeError(f"xor_sched differs from its plain version at the "
                           f"headline shape: max {err}")
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = phase_build()
    small_err = phase_kernels(dev)
    k3_small_err = phase_k3_small(dev, built)
    with xor_sched_env(None):          # the RS main path keeps its routing
        launches, main_inputs = phase_main_path(dev)
        phase_cauchy(dev)
    lrc = phase_linear(dev, "lrc", LRC, (0,), SEED + 5)
    pmsr = phase_linear(dev, "pmsr", PMSR, PMSR_LOST, SEED + 7)
    phase_autotune()
    line = phase_kernel_line(main_inputs, launches, small_err, lrc, pmsr,
                             k3_small_err)
    log(json.dumps(line))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / GiB:.2f} "
        f"GiB, total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
