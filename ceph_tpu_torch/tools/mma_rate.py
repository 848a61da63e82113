"""Measure the tensor-core MMA rates K1 and K2 stand on, on the card.

    python -m ceph_tpu_torch.tools.mma_rate

Builds ``csrc/mma_rate.cu`` and times its kernel: 8 independent accumulator
chains a warp, 4 blocks of 8 warps a SM, each warp issuing ``ITERS`` x 8
``mma.sync`` of one kind: the single-bit m16n8k256 ``.b1 .and.popc``
product (K1) and the u8 m16n8k32 product (K2).  The rate is MMAs a clock a
SM: MMAs / (CUDA-event seconds x SMs x the SM clock nvidia-smi reads while
the kernel runs).  Prints one JSON object with the card's name and power
limit.  No data sheet gives Hopper's single-bit rate; ``chip_smoke.py``
takes the measured one as that product's peak in K1's bounds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

ITERS = 4096
LAUNCHES = 100      # timed launches of each kind, enqueued before the clock is read
CHAINS = 8          # csrc/mma_rate.cu kChains
THREADS = 256       # csrc/mma_rate.cu kThreads
KINDS = {"b1 m16n8k256 and.popc": 0, "u8 m16n8k32": 1}


def _smi(query: str, fmt: str = "csv,noheader,nounits") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def measure(device) -> dict:
    """{kind: {"ms", "mmas", "sm_clock_mhz", "mma_per_clock_per_sm"}} on
    ``device`` (a CUDA torch.device)."""
    import torch
    from ceph_tpu_torch.ops import _build

    lib = _build.library("mma_rate")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate.argtypes = [i, i, i, vp, i, vp]
    lib.mma_rate.restype = i
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = 4 * sms
    sink = torch.empty(blocks * THREADS, dtype=torch.int32, device=device)
    stream = vp(torch.cuda.current_stream(device).cuda_stream)

    def launch(kind):
        err = lib.mma_rate(kind, blocks, ITERS, sink.data_ptr(), device.index,
                           stream)
        if err:
            raise RuntimeError(f"mma_rate: launch failed with CUDA error {err}")

    out = {}
    for name, kind in KINDS.items():
        for _ in range(3):
            launch(kind)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            launch(kind)
        end.record()
        clock = _smi("clocks.sm")      # read while the launches run
        end.synchronize()
        ms = start.elapsed_time(end) / LAUNCHES
        mhz = float(clock) if clock.isdigit() else float(_smi("clocks.max.sm"))
        mmas = blocks * (THREADS // 32) * ITERS * CHAINS
        out[name] = {"ms": ms, "mmas": mmas, "sm_clock_mhz": mhz,
                     "mma_per_clock_per_sm":
                         mmas / (ms * 1e-3 * sms * mhz * 1e6)}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    rates = measure(dev)
    print(json.dumps({"card": _smi("name,power.limit", "csv,noheader"), "sms":
                      torch.cuda.get_device_properties(dev).multi_processor_count,
                      "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
