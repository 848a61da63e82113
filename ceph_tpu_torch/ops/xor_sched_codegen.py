"""Generate the CUDA source of kernel K3 (``xor_sched``) for one schedule.

Each compiled ``XorSchedule`` becomes one source: the schedule's SSA XORs as
straight-line code inside ``csrc/xor_sched.cuh``'s kernel, so every value
lives in a register.  The entry ``xor_sched_<digest>`` has the calling
convention of K1/K2 (data, out, B, k, r, L, device, stream) and returns
``cudaGetLastError()``.  An output row is packed and stored right after the
op that completes its last plane, so finished rows hold no registers.
"""

from __future__ import annotations

from .xor_schedule import XorSchedule

HEADER = "xor_sched.cuh"


def entry_name(sched: XorSchedule) -> str:
    return f"xor_sched_{sched.digest}"


def _value(v: int, n_in: int) -> str:
    if v < 0:
        return "0u"                    # an all-zero output row
    return f"x{v}" if v < n_in else f"v{v}"


def generate(sched: XorSchedule) -> str:
    """The CUDA C++ source of K3 for ``sched`` (n_in = 8k, n_out = 8r)."""
    n_in, n_out = sched.n_in, sched.n_out
    if n_in % 8 or n_out % 8:
        raise ValueError(f"schedule {sched.digest} is {n_out}x{n_in}: K3 "
                         f"needs whole bytes (multiples of 8) on both sides")
    k, r = n_in // 8, n_out // 8
    # output rows by the op after which all 8 of their planes exist
    ready: dict[int, list[int]] = {}
    for i in range(r):
        ids = sched.outputs[8 * i:8 * i + 8]
        last = max((v - n_in for v in ids if v >= n_in), default=-1)
        ready.setdefault(last, []).append(i)

    def stores(idx: int) -> list[str]:
        out = []
        for i in ready.get(idx, ()):
            planes = ", ".join(_value(v, n_in)
                               for v in sched.outputs[8 * i:8 * i + 8])
            out.append(f"    {{ const uint32_t o[8] = {{{planes}}}; "
                       f"io.store({i}, o); }}")
        return out

    body = []
    for j in range(k):
        names = " ".join(f"x{8 * j + s} = p[{s}];" for s in range(8))
        body.append(f"    {{ uint32_t p[8]; io.load({j}, p); {names} }}")
    body += stores(-1)
    for idx, (a, b) in enumerate(sched.ops):
        body.append(f"    const uint32_t v{n_in + idx} = "
                    f"{_value(a, n_in)} ^ {_value(b, n_in)};")
        body += stores(idx)
    inputs = ", ".join(f"x{v}" for v in range(n_in))
    return "\n".join([
        "// Generated by ceph_tpu_torch/ops/xor_sched_codegen.py; do not edit.",
        f"// Schedule {sched.digest}: {n_out}x{n_in} GF(2) matrix, "
        f"{sched.n_terms} XORs (naive {sched.naive_terms}), "
        f"peak {sched.peak_registers} live temporaries.",
        f'#include "{HEADER}"',
        "",
        "namespace {",
        "",
        "struct Body {",
        f"  static constexpr int K = {k};",
        f"  static constexpr int R = {r};",
        "  XS_FN void operator()(const xor_sched::Io& io) const {",
        f"    uint32_t {inputs};",
        *body,
        "  }",
        "};",
        "",
        "}  // namespace",
        "",
        f"XOR_SCHED_ENTRY({entry_name(sched)}, Body)",
        "",
    ])
