"""XOR-schedule compiler and the scheduled GF(2) bit-matmul engine.

A GF(2^8) coefficient matrix applied to stripes is, bit for bit, a 0/1
matrix over GF(2), and that matrix IS a set of XOR equations.  Common-
subexpression elimination over those equations plus a good evaluation order
cuts the XOR count severalfold for the sparse matrices of the recovery codes
(LRC local parities, PMSR repair matrices).

The host half is ``ceph_tpu/ops/xor_schedule.py``'s and must give what it
gives: ``compile_schedule`` yields the identical op stream for the same
matrix bytes (greedy pairwise CSE, its picks taken from a heap here, then
just-in-time topological lowering into SSA XOR ops with a proven register
bound), schedules are cached process-wide by matrix digest, and
``apply_host`` runs one on numpy rows.

The device half:

  * ``apply_bits_plain`` -- the plain PyTorch version of the reference's
    ``apply_bits_traced`` on (B, k, L) uint8 tensors;
  * ``sched_matmul_batch_device`` -- the wrapper of kernel K3 ``xor_sched``
    (CUDA C++ generated per digest by ``xor_sched_codegen``): the plain
    version for a CPU tensor, the kernel for a CUDA tensor.  A failed build,
    a failed launch or a first output that differs from the host oracle
    raises; nothing falls back to the dense kernels;
  * ``want_scheduled`` -- the cost model, with the reference's precedence:
    the ``CEPH_TPU_XOR_SCHED`` override (``0`` dense, ``1`` scheduled), then
    the tuned table (``gf2kernels._TUNED_PATH``, written by
    ``tools/ec_autotune.py``), then the backend rule: dense on the card, as
    the reference is dense on a TPU, and a terms-vs-MACs heuristic on the CPU;
  * ``maybe_batch_scheduled`` -- the routing hook of
    ``gf2kernels.gf_matmul_batch_device``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import os
import threading
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

# default register-file bound for compiled schedules: peak concurrently
# live temporaries.  64 matches a comfortable vector-register budget on
# every target; the compiler PROVES the bound (re-compiling with fewer
# temps if the first schedule exceeds it) rather than assuming it.
DEFAULT_MAX_REGISTERS = 64

# cost-model default: on CPU engines the dense contraction runs R*C
# multiply-accumulates per byte column while the schedule runs n_terms
# XORs; the MAC is not 1:1 with an XOR (XLA vectorizes both), so the
# schedule must beat the dense length by this factor to be picked.
CPU_DENSE_DISCOUNT = 0.35

# matrices beyond this many cells are not worth a Python-side CSE pass
# (nothing on the codec path is remotely this large)
MAX_COMPILE_CELLS = 1 << 18

# the SPECULATIVE compile bound: the backend heuristic and the
# build-time warms compile on the chance the schedule wins, and the
# greedy-CSE pass is quadratic in pair count -- a dense 20k-cell
# matrix (the pmsr k=5 parity bitmatrix) costs ~15s of pure Python,
# which would stall codec init / the first launch's event loop.
# Above this bound only an EXPLICIT opt-in compiles: a measured
# gf2_tuned.json entry or CEPH_TPU_XOR_SCHED=1 (both accept the
# one-time cost knowingly).
SPECULATIVE_MAX_CELLS = 1 << 14

# below this many bytes per plane row the naive xor_matmul's C-level
# gather+reduce beats the schedule's one-numpy-call-per-XOR dispatch
# overhead (measured crossover ~10 KiB; CEPH_TPU_XOR_SCHED=1 forces
# the scheduled engine anyway, e.g. for parity tests)
HOST_MIN_LANE = 16384


@dataclass(frozen=True)
class XorSchedule:
    """A compiled XOR evaluation plan for one GF(2) bit-matrix.

    Value ids are SSA: ids ``0..n_in-1`` are the input rows, id
    ``n_in + i`` is the value produced by ``ops[i] = (a, b)`` (the XOR
    of values ``a`` and ``b``).  ``outputs[j]`` names the value holding
    output row j -- possibly an input id (a single-one matrix row is a
    copy) or -1 (an all-zero row).
    """

    digest: str
    n_in: int
    n_out: int
    ops: tuple[tuple[int, int], ...]
    outputs: tuple[int, ...]
    naive_terms: int
    peak_registers: int
    max_registers: int

    @property
    def n_terms(self) -> int:
        return len(self.ops)

    @property
    def terms_saved(self) -> int:
        return self.naive_terms - self.n_terms

    @property
    def reduction(self) -> float:
        if not self.naive_terms:
            return 0.0
        return 1.0 - self.n_terms / self.naive_terms

    def last_uses(self) -> list[int]:
        """For each op value, the last OP index that reads it (its own
        definition index when no later op does).  Output stores happen
        eagerly at definition time (the executors write the output row
        the moment its value exists), so they do not extend a value's
        lifetime."""
        last = list(range(len(self.ops)))
        n_in = self.n_in
        for i, (a, b) in enumerate(self.ops):
            if a >= n_in:
                last[a - n_in] = i
            if b >= n_in:
                last[b - n_in] = i
        return last

    def outputs_by_value(self) -> dict[int, list[int]]:
        """value id -> output rows it serves (eager-store map)."""
        by_val: dict[int, list[int]] = {}
        for j, o in enumerate(self.outputs):
            by_val.setdefault(o, []).append(j)
        return by_val


def matrix_digest(matrix: np.ndarray) -> str:
    """Content digest of a 0/1 matrix; the process-wide schedule key."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    h = hashlib.sha256()
    h.update(b"%d,%d;" % m.shape)
    h.update(m.tobytes())
    return h.hexdigest()[:16]


def naive_xor_terms(matrix: np.ndarray) -> int:
    """XOR count of the row-by-row evaluation (ones - 1 per nonzero
    row): the baseline the schedule is measured against."""
    ones = (np.ascontiguousarray(matrix, np.uint8) != 0).sum(axis=1)
    return int(np.maximum(ones - 1, 0).sum())


# ---------------------------------------------------------------------------
# CSE + lowering
# ---------------------------------------------------------------------------

def _greedy_cse(rows: list[set[int]], n_in: int,
                max_temps: int) -> list[tuple[int, int]]:
    """Extract the most-shared operand pair into a temporary until no
    pair is shared by two equations (or the temp budget is spent).
    Deterministic: ties break to the smallest (a, b) pair.  Returns the
    temp definitions; ``rows`` is rewritten in place to reference them.

    The reference scans every pair count for each pick; here a heap
    keyed (-count, pair) holds an entry for each pair's current count
    (entries whose count has since moved are dropped as they surface),
    which picks the same pair at every step.
    """
    counts: Counter[tuple[int, int]] = Counter()
    for row in rows:
        ordered = sorted(row)
        for i, a in enumerate(ordered):
            for b in ordered[i + 1:]:
                counts[(a, b)] += 1
    heap = [(-n, pair) for pair, n in counts.items()]
    heapq.heapify(heap)
    temps: list[tuple[int, int]] = []
    while len(temps) < max_temps and heap:
        neg, (a, b) = heapq.heappop(heap)
        n = counts.get((a, b), 0)
        if n != -neg:
            continue                    # a stale count: a newer entry holds it
        if n < 2:
            break
        t = n_in + len(temps)
        temps.append((a, b))
        touched: set[tuple[int, int]] = set()
        for row in rows:
            if a in row and b in row:
                # incremental pair-count maintenance: pairs that lose a
                # member leave, pairs gaining the temp enter
                row.discard(a)
                row.discard(b)
                dropped = [(a, b)]
                for x in row:
                    for m in (a, b):
                        dropped.append((x, m) if x < m else (m, x))
                for pair in dropped:
                    counts[pair] -= 1
                    if not counts[pair]:
                        del counts[pair]
                touched.update(dropped)
                for x in row:
                    pair = (x, t) if x < t else (t, x)
                    counts[pair] += 1
                    touched.add(pair)
                row.add(t)
        for pair in touched:
            if pair in counts:
                heapq.heappush(heap, (-counts[pair], pair))
    return temps


def _substitute(rows: list[set[int]], n_in: int,
                temps: list[tuple[int, int]]) -> None:
    """Rewrite ``rows`` in place as ``_greedy_cse`` does when it defines
    ``temps`` in order: the rows of a run whose budget stopped it there."""
    for i, (a, b) in enumerate(temps):
        for row in rows:
            if a in row and b in row:
                row.discard(a)
                row.discard(b)
                row.add(n_in + i)


def _lower(n_in: int, temps: list[tuple[int, int]],
           rows: list[set[int]]) -> tuple[tuple, tuple]:
    """Just-in-time topological lowering: a temporary's op is emitted
    immediately before its first use, outputs are left-to-right XOR
    chains.  Returns (ops, outputs) in SSA ids."""
    ops: list[tuple[int, int]] = []
    emitted: dict[int, int] = {}

    def resolve(x: int) -> int:
        if x < n_in:
            return x
        sid = emitted.get(x)
        if sid is None:
            a, b = temps[x - n_in]
            ia, ib = resolve(a), resolve(b)
            ops.append((ia, ib))
            sid = emitted[x] = n_in + len(ops) - 1
        return sid

    outputs: list[int] = []
    for row in rows:
        operands = sorted(row)
        if not operands:
            outputs.append(-1)
            continue
        acc = resolve(operands[0])
        for x in operands[1:]:
            ops.append((acc, resolve(x)))
            acc = n_in + len(ops) - 1
        outputs.append(acc)
    return tuple(ops), tuple(outputs)


def _peak_registers(n_in: int, ops: tuple, outputs: tuple) -> int:
    """Max concurrently-live computed values over the schedule.
    Inputs are free (they are the resident input array) and output
    stores happen at definition time, so a value lives from its op to
    its last OP use."""
    last = list(range(len(ops)))
    for i, (a, b) in enumerate(ops):
        for v in (a, b):
            if v >= n_in:
                last[v - n_in] = i
    deaths = Counter(last)
    live = peak = 0
    for i in range(len(ops)):
        live += 1
        peak = max(peak, live)
        live -= deaths.get(i, 0)
    return peak


def compile_schedule(matrix: np.ndarray, *,
                     max_registers: int = DEFAULT_MAX_REGISTERS,
                     max_temps: int | None = None) -> XorSchedule:
    """Lower a GF(2) 0/1 matrix to a CSE-minimized XOR schedule.

    Deterministic: the same matrix bytes always produce the identical
    schedule (pinned against the reference by
    tests/test_torch_xor_schedule.py), so the digest is a complete cache
    key across processes.
    """
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"bit-matrix must be 2-D, got {m.shape}")
    if m.size > MAX_COMPILE_CELLS:
        raise ValueError(f"matrix {m.shape} too large to schedule")
    n_out, n_in = m.shape
    digest = matrix_digest(m)
    naive = naive_xor_terms(m)
    budget = max_temps if max_temps is not None else m.size
    # a pick never depends on the budget, so a smaller budget's run is the
    # first picks of the largest: run the greedy once, then replay a prefix
    first = [set(np.flatnonzero(r).tolist()) for r in m]
    rows = [set(r) for r in first]
    picks = _greedy_cse(rows, n_in, budget)
    while True:
        temps = picks[:budget]
        if len(temps) < len(picks):
            rows = [set(r) for r in first]
            _substitute(rows, n_in, temps)
        ops, outputs = _lower(n_in, temps, rows)
        peak = _peak_registers(n_in, ops, outputs)
        if peak <= max_registers or budget == 0:
            break
        # too much sharing to hold in the register file: shrink the
        # temp budget (halving terminates at the naive schedule, whose
        # only live value is the running accumulator)
        budget = min(budget, len(temps)) // 2
    return XorSchedule(digest=digest, n_in=n_in, n_out=n_out, ops=ops,
                       outputs=outputs, naive_terms=naive,
                       peak_registers=peak, max_registers=max_registers)


# ---------------------------------------------------------------------------
# process-wide schedule cache + launch stats
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_SCHEDULES: dict[str, XorSchedule] = {}


class _Stats:
    """Process-wide scheduled-engine counters, with the reference's three
    fields.  ``fallbacks`` stays 0: the port never falls back."""

    __slots__ = ("launches", "fallbacks", "terms_saved")

    def __init__(self) -> None:
        self.launches = 0
        self.fallbacks = 0
        self.terms_saved = 0

    def snapshot(self) -> tuple[int, int, int]:
        with _LOCK:
            return (self.launches, self.fallbacks, self.terms_saved)

    def note_launch(self, sched: XorSchedule) -> None:
        with _LOCK:
            self.launches += 1
            self.terms_saved += sched.terms_saved


STATS = _Stats()


def schedule_for(matrix: np.ndarray, *,
                 compile_missing: bool = True) -> XorSchedule | None:
    """The cached schedule for a bit-matrix, compiling (and caching it
    process-wide) on miss unless ``compile_missing`` is False."""
    digest = matrix_digest(matrix)
    with _LOCK:
        sched = _SCHEDULES.get(digest)
    if sched is not None or not compile_missing:
        return sched
    sched = compile_schedule(matrix)
    with _LOCK:
        return _SCHEDULES.setdefault(digest, sched)


def cached_schedule(matrix: np.ndarray) -> XorSchedule | None:
    return schedule_for(matrix, compile_missing=False)


def registered(digest: str) -> XorSchedule:
    with _LOCK:
        return _SCHEDULES[digest]


def clear_schedule_cache() -> None:
    with _LOCK:
        _SCHEDULES.clear()
    _checked.clear()
    _k3_entry.cache_clear()


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def apply_host(sched: XorSchedule, planes: np.ndarray) -> np.ndarray:
    """(n_in, N) byte rows -> (n_out, N) byte rows on the host.

    Output rows are stored the moment their value exists and
    temporaries are freed at last use, so the working set matches the
    schedule's ``peak_registers`` bound."""
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    assert planes.shape[0] == sched.n_in, (planes.shape, sched.n_in)
    n_in = sched.n_in
    last = sched.last_uses()
    by_val = sched.outputs_by_value()
    out = np.zeros((sched.n_out, planes.shape[1]), dtype=np.uint8)
    for o, js in by_val.items():
        if 0 <= o < n_in:                  # single-one rows: copies
            for j in js:
                out[j] = planes[o]
    vals: dict[int, np.ndarray] = {}
    for i, (a, b) in enumerate(sched.ops):
        v = np.bitwise_xor(planes[a] if a < n_in else vals[a - n_in],
                           planes[b] if b < n_in else vals[b - n_in])
        for j in by_val.get(n_in + i, ()):
            out[j] = v                     # eager store at definition
        if last[i] > i:                    # a later op still needs it
            vals[i] = v
        for x in (a, b):
            if x >= n_in and last[x - n_in] == i:
                vals.pop(x - n_in, None)
    return out


def scheduled_xor_matmul(matrix: np.ndarray, planes: np.ndarray, *,
                         allow_compile: bool = True) -> np.ndarray:
    """Drop-in ``gf.gf2w.xor_matmul`` with the scheduled engine: uses
    the cached (or, when allowed and profitable, freshly compiled)
    schedule, else the naive row-by-row XOR.  The BitMatrixCodec
    encode path compiles (the matrix is hot for the codec's lifetime);
    the repair path passes ``allow_compile=False`` and rides a
    schedule only when one is already cached (warmed at decode-matrix
    build time)."""
    env = os.environ.get("CEPH_TPU_XOR_SCHED")
    sched = cached_schedule(matrix)
    if sched is None and allow_compile \
            and matrix.size <= MAX_COMPILE_CELLS \
            and env != "0":
        sched = schedule_for(matrix)
    if sched is None or env == "0" \
            or sched.n_terms >= sched.naive_terms \
            or (env != "1" and planes.shape[1] < HOST_MIN_LANE):
        from ..gf.gf2w import xor_matmul
        return xor_matmul(np.ascontiguousarray(matrix, np.uint8),
                          planes)
    out = apply_host(sched, planes)
    STATS.note_launch(sched)
    return out


def _env_off() -> bool:
    return os.environ.get("CEPH_TPU_XOR_SCHED") == "0"


def warm_schedule(matrix: np.ndarray) -> XorSchedule | None:
    """Compile-and-cache when the matrix qualifies (called at decode-
    matrix build time, so subsequent repairs find a schedule cached and
    never pay the compile on the read path)."""
    if _env_off() or matrix.size > MAX_COMPILE_CELLS:
        return None
    sched = schedule_for(matrix)
    return sched if sched.n_terms < sched.naive_terms else None


def warm_gf8_schedule(matrix: np.ndarray) -> XorSchedule | None:
    """``warm_schedule`` for a GF(2^8) coefficient matrix: expand to
    the GF(2) bit-matrix the batched kernel family keys on
    (``gf2kernels.bitmatrix_i8``) and compile-and-cache its schedule.
    Called when a codec builds a repair/local-parity matrix, so the
    first batched launch with it finds the schedule cached and the
    read/recovery path never pays the CSE compile.  Matrices above
    the speculative bound are skipped -- codec init must never stall on
    a multi-second CSE pass for a matrix the cost model would not pick
    speculatively anyway."""
    if _env_off():
        return None
    from .gf2kernels import bitmatrix_i8
    bm = bitmatrix_i8(np.ascontiguousarray(matrix, np.uint8))
    if bm.size > SPECULATIVE_MAX_CELLS:
        return None
    return warm_schedule(bm)


def apply_bits_plain(sched: XorSchedule, data: torch.Tensor) -> torch.Tensor:
    """(B, k, L) uint8 -> (B, n_out//8, L) uint8: unpack to bit planes, run
    the schedule, pack.  The plain PyTorch version of K3, on any device;
    same plane order as the dense family (plane 8j+s = bit s of chunk j,
    matching ``bitmatrix_i8`` columns; output value 8i+t = bit t of row i)."""
    b, k, l = data.shape
    assert sched.n_in == 8 * k, (sched.n_in, k)
    assert sched.n_out % 8 == 0, sched.n_out
    planes = [(data[:, j] >> s) & 1 for j in range(k) for s in range(8)]
    n_in = sched.n_in
    last = sched.last_uses()
    by_val = sched.outputs_by_value()
    outvals: list = [None] * sched.n_out
    for o, js in by_val.items():
        if 0 <= o < n_in:                  # single-one rows: copies
            for j in js:
                outvals[j] = planes[o]
    vals: dict[int, torch.Tensor] = {}
    for i, (a, c) in enumerate(sched.ops):
        v = (planes[a] if a < n_in else vals[a - n_in]) \
            ^ (planes[c] if c < n_in else vals[c - n_in])
        for j in by_val.get(n_in + i, ()):
            outvals[j] = v                 # eager store at definition
        if last[i] > i:
            vals[i] = v
        for x in (a, c):
            if x >= n_in and last[x - n_in] == i:
                vals.pop(x - n_in, None)
    out = torch.zeros((b, sched.n_out // 8, l), dtype=torch.uint8,
                      device=data.device)
    for j, o in enumerate(outvals):
        if o is not None:
            out[:, j // 8] |= o << (j % 8)
    return out


# ---------------------------------------------------------------------------
# kernel K3 and its routing
# ---------------------------------------------------------------------------

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def k3_source(sched: XorSchedule) -> str:
    """Register K3's generated source for ``sched`` with the builder and
    return its name, for ``_build.build`` (one nvcc per digest)."""
    from . import _build
    from .xor_sched_codegen import entry_name, generate
    name = entry_name(sched)
    _build.add_generated(name, generate(sched))
    return name


@functools.lru_cache(maxsize=256)
def _k3_entry(digest: str):
    from . import _build
    name = k3_source(registered(digest))
    fn = getattr(_build.library(name), name)
    fn.argtypes = [_VP, _VP, _I, _I, _I, _LL, _I, _VP]
    fn.restype = _I
    return fn


def xor_sched(sched: XorSchedule, data: torch.Tensor) -> torch.Tensor:
    """K3: launch the schedule's kernel on a (B, k, L) uint8 CUDA tensor."""
    from .gf2kernels import LAUNCHES, _stream
    b, k, l = data.shape
    if data.device.type != "cuda" or data.dtype != torch.uint8 \
            or not data.is_contiguous() or sched.n_in != 8 * k:
        raise ValueError(f"xor_sched takes contiguous (B, {sched.n_in // 8}, "
                         f"L) uint8 CUDA data, got {tuple(data.shape)} "
                         f"{data.dtype} on {data.device}")
    with _LOCK:
        _SCHEDULES.setdefault(sched.digest, sched)
    fn = _k3_entry(sched.digest)
    out = torch.empty((b, sched.n_out // 8, l), dtype=torch.uint8,
                      device=data.device)
    err = fn(data.data_ptr(), out.data_ptr(), b, k, sched.n_out // 8, l,
             data.device.index, _stream(data.device))
    if err:
        raise RuntimeError(f"xor_sched {sched.digest}: kernel launch failed "
                           f"with CUDA error {err}")
    LAUNCHES["xor_sched"] += 1
    return out


# (digest, device type) pairs whose first output matched the host oracle
_checked: set[tuple[str, str]] = set()


def _first_use_check(sched: XorSchedule, matrix: np.ndarray,
                     x: torch.Tensor, out: torch.Tensor) -> None:
    """Hold the engine's first output for a schedule against the host GF(2^8)
    oracle on a 2-stripe x 256-byte slice; a mismatch raises."""
    key = (sched.digest, x.device.type)
    if key in _checked:
        return
    from ..gf import gf_matmul
    n, nb = min(256, x.shape[2]), min(2, x.shape[0])
    # lint: disable=device-path-host-sync -- first-use check, once a key
    got = out[:nb, :, :n].cpu().numpy()
    # lint: disable=device-path-host-sync -- first-use check, once a key
    sample = x[:nb, :, :n].cpu().numpy()
    for i in range(nb):
        if not np.array_equal(got[i], gf_matmul(matrix, sample[i])):
            raise RuntimeError(f"xor_sched {sched.digest}: output differs "
                               f"from the host GF(2^8) oracle")
    _checked.add(key)


def sched_matmul_batch_device(sched: XorSchedule, matrix: np.ndarray,
                              x: torch.Tensor) -> torch.Tensor:
    """The scheduled engine on a (B, k, L) uint8 tensor of the (r, k)
    GF(2^8) coefficient ``matrix`` whose bit-matrix ``sched`` computes:
    (B, r, L) on the tensor's device.  The plain version serves a CPU
    tensor, K3 a CUDA tensor; there is no fallback."""
    if x.device.type == "cpu":
        out = apply_bits_plain(sched, x)
    else:
        out = xor_sched(sched, x)
    _first_use_check(sched, np.ascontiguousarray(matrix, np.uint8), x, out)
    STATS.note_launch(sched)
    return out


def _tuned_engine(k: int, m: int, lane: int) -> str | None:
    """The autotuned dense-vs-scheduled winner for this (k, m) family
    from the tuned table (``tools/ec_autotune.py`` writes it), exact
    chunk first, family default second."""
    from .gf2kernels import _tuned_cfgs
    table = _tuned_cfgs().get("xor_sched")
    if not isinstance(table, dict):
        return None
    hit = table.get(f"{k},{m},{lane}") or table.get(f"{k},{m}")
    if isinstance(hit, dict):
        hit = hit.get("engine")
    return hit if hit in ("dense", "scheduled") else None


def want_scheduled(bitmatrix: np.ndarray, lane: int,
                   backend: str) -> XorSchedule | None:
    """The per-(matrix, shape) cost model: the schedule to launch with,
    or None (dense wins).  Precedence: CEPH_TPU_XOR_SCHED env override,
    the autotuned winner recorded in the tuned table, then the backend
    heuristic -- scheduled XOR terms vs the dense contraction length
    (R*C MACs per byte column), discounted because a vectorized MAC
    and a vectorized XOR are not 1:1.  Any backend but "cpu" (the card)
    defaults dense, as the reference does on a TPU; only a measured
    tuned entry may override it there."""
    env = os.environ.get("CEPH_TPU_XOR_SCHED")
    if env == "0":
        return None
    if bitmatrix.size > MAX_COMPILE_CELLS \
            or bitmatrix.shape[0] % 8 or bitmatrix.shape[1] % 8:
        return None
    if env == "1":
        return schedule_for(bitmatrix)
    tuned = _tuned_engine(bitmatrix.shape[1] // 8,    # k data chunks
                          bitmatrix.shape[0] // 8,    # m parity rows
                          lane)
    if tuned == "scheduled":
        return schedule_for(bitmatrix)
    if tuned == "dense":
        return None
    if backend != "cpu":
        return None
    if bitmatrix.size > SPECULATIVE_MAX_CELLS:
        return None            # dense family serves; tune to opt in
    sched = schedule_for(bitmatrix)
    dense_macs = bitmatrix.shape[0] * bitmatrix.shape[1]
    if sched.n_terms <= CPU_DENSE_DISCOUNT * dense_macs:
        return sched
    return None


def maybe_batch_scheduled(matrix: np.ndarray,
                          x: torch.Tensor) -> torch.Tensor | None:
    """The gf2kernels routing hook: run the coefficient-matrix batch
    through the scheduled engine when the cost model picks it for the
    tensor's device.  Returns the output, or None (dense serves)."""
    from .gf2kernels import bitmatrix_i8
    sched = want_scheduled(bitmatrix_i8(matrix), x.shape[2], x.device.type)
    if sched is None:
        return None
    return sched_matmul_batch_device(sched, matrix, x)
