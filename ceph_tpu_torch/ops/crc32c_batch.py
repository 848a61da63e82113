"""Batched CRC32C: whole-batch checksums for the integrity pipeline.

Port of ``ceph_tpu/ops/crc32c_batch.py``.

* Host half, copied: the slice-by-8 tables, the GF(2) register algebra
  (``crc32c_zeros`` / ``crc32c_combine`` / ``crc32c_strip_zeros`` /
  ``fold_chunk_crcs``: advancing a CRC over n zero bytes is the 32x32
  bit-matrix M^n, so ragged buffers are zero-padded, checksummed in
  lockstep and un-padded by the inverse matrix, and chunk CRCs fold into
  whole-shard CRCs without re-reading a byte), and the reference's ladder
  behind ``crc32c_rows`` / ``crc32c_batch``: one call into the host
  engine (``native.py``, the port's copy of the reference's C source),
  or with ``backend="numpy"`` the numpy lockstep engine, which gives the
  same bytes.  The host engine is built at first use; a failed build
  raises rather than falling back.

* Device half: ``crc32c_chunks`` is kernel K4 (``csrc/crc32c.cu``) for a
  CUDA tensor and its plain PyTorch version ``crc32c_chunks_plain`` for a
  CPU tensor.  It also carries the reference's ``crc32c_chunks_traced``
  contract (the same math with no counters, for use inside a fused
  launch): PyTorch traces nothing, so the codec paths call it directly.
  ``crc32c_chunks_pair`` checksums two sets of rows (a fused encode's data
  and parity) in one launch.  ``crc32c_device_chunks`` adds the ``PERF``
  counters, ``crc32c_resident`` checksums a whole buffer in one launch
  plus a host fold.

CRCs on the device are int64 tensors holding the 32-bit register
(``torch.uint32`` has few operations); ``to_uint32`` converts them to the
reference's ``np.uint32`` at the host boundary, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import native
from ..common.perf import PerfCounters
from ..device import resolve_device
from . import _build

SEED = 0xFFFFFFFF
_POLY = 0x82F63B78                  # reversed Castagnoli

# process-wide integrity counter set: batched host calls, bytes hashed,
# fused device launches
PERF = PerfCounters("integrity")


# -- slice tables -----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tables() -> np.ndarray:
    """(8, 256) uint32 slice-by-8 tables (t[0] = plain byte table)."""
    t = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[0, i] = c
    for s in range(1, 8):
        t[s] = t[0][t[s - 1] & 0xFF] ^ (t[s - 1] >> 8)
    return t


# -- GF(2) register algebra -------------------------------------------------
# A 32x32 GF(2) matrix is a (32,) uint32 array of COLUMNS: applying it
# to a register XORs together the columns selected by the register's
# set bits.  The CRC update over data is affine in (register, data), so
# advancing over n zero bytes is purely linear: reg' = M^n . reg.

def _mat_apply(mat: np.ndarray, v) -> np.ndarray:
    """Apply a (32,) column-matrix to a scalar/array of registers."""
    v = np.asarray(v, np.uint32)
    bits = ((v[..., None] >> np.arange(32, dtype=np.uint32)) & 1) != 0
    return np.bitwise_xor.reduce(
        np.where(bits, mat, np.uint32(0)), axis=-1)


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a . b): column i of the product is a applied to b's column i."""
    return _mat_apply(a, b)


@functools.lru_cache(maxsize=1)
def _zero_byte_matrix() -> np.ndarray:
    """M: one zero-byte register update, reg' = (reg >> 8) ^ T0[reg & 0xff]."""
    t0 = _tables()[0]
    cols = np.zeros(32, np.uint32)
    for i in range(32):
        v = np.uint32(1 << i)
        cols[i] = (v >> np.uint32(8)) ^ t0[v & 0xFF]
    return cols


def _mat_inv(mat: np.ndarray) -> np.ndarray:
    """GF(2) inverse by Gauss-Jordan on 64-bit augmented rows."""
    rows = []
    for r in range(32):
        row = 0
        for c in range(32):
            row |= ((int(mat[c]) >> r) & 1) << c
        rows.append(row | (1 << (32 + r)))
    for col in range(32):
        piv = next(r for r in range(col, 32) if (rows[r] >> col) & 1)
        rows[col], rows[piv] = rows[piv], rows[col]
        for r in range(32):
            if r != col and (rows[r] >> col) & 1:
                rows[r] ^= rows[col]
    inv = np.zeros(32, np.uint32)
    for c in range(32):
        col = 0
        for r in range(32):
            col |= ((rows[r] >> (32 + c)) & 1) << r
        inv[c] = col
    return inv


@functools.lru_cache(maxsize=64)
def _zeros_pow2(b: int) -> np.ndarray:
    """M^(2^b): advance over 2^b zero bytes."""
    if b == 0:
        return _zero_byte_matrix()
    m = _zeros_pow2(b - 1)
    return _mat_mul(m, m)


@functools.lru_cache(maxsize=64)
def _inv_zeros_pow2(b: int) -> np.ndarray:
    """(M^-1)^(2^b): strip 2^b trailing zero bytes."""
    if b == 0:
        return _mat_inv(_zero_byte_matrix())
    m = _inv_zeros_pow2(b - 1)
    return _mat_mul(m, m)


@functools.lru_cache(maxsize=256)
def _zeros_matrix(n: int) -> np.ndarray:
    """M^n via the binary ladder (few distinct n recur: segment and
    chunk lengths)."""
    assert n >= 0
    out = None
    b = 0
    while n:
        if n & 1:
            sq = _zeros_pow2(b)
            out = sq if out is None else _mat_mul(sq, out)
        n >>= 1
        b += 1
    if out is None:                  # n == 0: identity
        return (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return out


def crc32c_zeros(crc, n: int):
    """Advance CRC register(s) over ``n`` zero bytes (raw register
    semantics: the CRC of ``n`` zero bytes from ``crc``)."""
    out = _mat_apply(_zeros_matrix(int(n)), crc)
    return int(out) if np.ndim(crc) == 0 else out


def crc32c_combine(crc_a, crc_b, len_b: int):
    """``crc32c(a + b)`` from ``crc32c(a)`` and ``crc32c(b)`` (both
    with the default seed) without touching the bytes:
    M^len_b . (crc_a ^ seed) ^ crc_b."""
    a = np.asarray(crc_a, np.uint32) ^ np.uint32(SEED)
    out = _mat_apply(_zeros_matrix(int(len_b)), a) \
        ^ np.asarray(crc_b, np.uint32)
    return int(out) if np.ndim(crc_a) == 0 and np.ndim(crc_b) == 0 \
        else out


def crc32c_strip_zeros(crcs, nzeros):
    """Undo a zero suffix: given crc(buf + zeros), recover crc(buf).

    Zero-extension is the invertible linear map M^z, so the batched
    engines can pad ragged buffers to a common length, run in lockstep,
    and un-pad here; the codec batcher uses it to fix up fused CRCs
    computed at the padded lane width.  ``nzeros`` is a scalar or an
    array broadcastable to ``crcs``.
    """
    crcs = np.asarray(crcs, np.uint32)
    z = np.broadcast_to(np.asarray(nzeros, np.int64), crcs.shape)
    out = crcs.copy()
    maxz = int(z.max()) if z.size else 0
    b = 0
    while (1 << b) <= maxz:
        mask = ((z >> b) & 1) != 0
        if mask.any():
            out = np.where(mask, _mat_apply(_inv_zeros_pow2(b), out),
                           out)
        b += 1
    return out


def fold_chunk_crcs(chunk_crcs, chunk_len: int):
    """CRC of the concatenation along axis 0 of equal-length chunks,
    from their individual CRCs (default seed each): the host-side fold
    that turns a launch's per-stripe chunk CRCs into whole-shard CRCs
    without re-reading the bytes."""
    cc = np.asarray(chunk_crcs, np.uint32)
    if cc.shape[0] == 0:
        return np.full(cc.shape[1:], SEED, np.uint32)
    mat = _zeros_matrix(int(chunk_len))
    f = np.uint32(SEED)
    acc = cc[0]
    for s in range(1, cc.shape[0]):
        acc = _mat_apply(mat, acc ^ f) ^ cc[s]
    PERF.inc("combine_folds", max(0, cc.shape[0] - 1))
    return acc


# -- numpy lockstep engine --------------------------------------------------

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pick_seg(n_rows: int, lp: int) -> int:
    """Segment length for the chunk-split: shorter segments mean more
    parallel lanes (good for few rows) but more combine levels."""
    seg = 512
    while seg > 16 and n_rows * ((lp + seg - 1) // seg) < 1024:
        seg //= 2
    return seg


def _lockstep(lanes: np.ndarray, crc: np.ndarray) -> np.ndarray:
    """Slice-by-8 over (N, L) lanes in lockstep; L % 8 == 0.  ``crc``
    carries per-lane seeds and returns the raw registers."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _tables()
    u64 = lanes.view("<u8")
    for j in range(lanes.shape[1] // 8):
        v = u64[:, j]
        x = crc.astype(np.uint64) ^ v
        crc = (t7[(x & 0xFF).astype(np.intp)]
               ^ t6[((x >> 8) & 0xFF).astype(np.intp)]
               ^ t5[((x >> 16) & 0xFF).astype(np.intp)]
               ^ t4[((x >> 24) & 0xFF).astype(np.intp)]
               ^ t3[((v >> 32) & 0xFF).astype(np.intp)]
               ^ t2[((v >> 40) & 0xFF).astype(np.intp)]
               ^ t1[((v >> 48) & 0xFF).astype(np.intp)]
               ^ t0[(v >> 56).astype(np.intp)])
    return crc


def _crc_rows_numpy(arr: np.ndarray, lengths: np.ndarray,
                    seed: int) -> np.ndarray:
    """Rows of a zero-padded (N, L) array -> (N,) uint32, pure numpy.

    Chunk-split + combine: each row splits into S power-of-two
    segments checksummed in lockstep across N*S lanes, a log2(S)-level
    tree of M^len combines folds them back, and the per-row zero
    padding is stripped by the inverse matrix.
    """
    n, l = arr.shape
    if n == 0:
        return np.zeros(0, np.uint32)
    seg = _pick_seg(n, max(l, 8))
    s = _next_pow2(max(1, -(-max(l, 1) // seg)))
    lp = s * seg
    if lp != l:
        padded = np.zeros((n, lp), np.uint8)
        padded[:, :l] = arr
        arr = padded
    lanes = np.ascontiguousarray(arr).reshape(n * s, seg)
    crc0 = np.zeros(n * s, np.uint32)
    crc0[::s] = np.uint32(seed)     # leftmost segment carries the seed
    crcs = _lockstep(lanes, crc0).reshape(n, s)
    width = seg
    while crcs.shape[1] > 1:        # combine pairs, doubling coverage
        mat = _zeros_matrix(width)
        crcs = _mat_apply(mat, crcs[:, 0::2]) ^ crcs[:, 1::2]
        width *= 2
    return crc32c_strip_zeros(
        crcs[:, 0],
        lp - np.asarray(lengths, np.int64))


def crc32c_numpy_one(data, crc: int = SEED) -> int:
    """Single-buffer numpy engine."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
    if buf.size == 0:
        return crc & 0xFFFFFFFF
    return int(_crc_rows_numpy(buf.reshape(1, -1),
                               np.array([buf.size], np.int64), crc)[0])


# -- batched entry points ---------------------------------------------------

def crc32c_rows(arr, lengths=None, seed: int = SEED,
                backend: str | None = None) -> np.ndarray:
    """CRCs of the rows of a (N, L) uint8 array in one pass.

    ``lengths`` (optional, per-row) truncates row i to its first
    ``lengths[i]`` bytes; the bytes beyond may be anything.  ``backend``
    "native" (the default) is one call into the host engine
    (``native.py``), "numpy" the numpy lockstep engine.
    """
    arr = np.ascontiguousarray(arr, np.uint8)
    assert arr.ndim == 2, arr.shape
    n, l = arr.shape
    lens = (np.full(n, l, np.int64) if lengths is None
            else np.asarray(lengths, np.int64))
    _check_backend(backend)
    PERF.inc("batched_calls")
    PERF.inc("batched_bufs", n)
    PERF.inc("batched_bytes", int(lens.sum()))
    if backend != "numpy" and n:
        crcs = np.full(n, seed, np.uint32)
        offs = np.arange(n, dtype=np.uint64) * np.uint64(l)
        native.crc32c_batch_native(crcs, arr.reshape(-1), offs,
                                   lens.astype(np.uint64))
        PERF.inc("native_batches")
        return crcs
    PERF.inc("numpy_batches")
    if lengths is not None and bool((lens < l).any()):
        arr = arr.copy()
        arr[np.arange(l) >= lens[:, None]] = 0
    return _crc_rows_numpy(arr, lens, seed)


def crc32c_batch(bufs, seed: int = SEED,
                 backend: str | None = None) -> np.ndarray:
    """CRCs of a ragged sequence of buffers (bytes-like or uint8
    arrays) in one pass; empty buffers come back as the seed, exactly
    like the scalar call.  ``backend`` as for ``crc32c_rows``."""
    bufs = bufs if isinstance(bufs, (list, tuple)) else list(bufs)
    n = len(bufs)
    _check_backend(backend)
    # fast marshal: one C-level join (or a pointer table) instead of a
    # numpy view per buffer
    if all(type(b) is bytes for b in bufs):
        lens = np.fromiter((len(b) for b in bufs), np.int64, count=n)
        views = None
    else:
        views = [np.ascontiguousarray(b, np.uint8).reshape(-1)
                 if isinstance(b, np.ndarray) else np.frombuffer(b, np.uint8)
                 for b in bufs]
        lens = np.fromiter((v.size for v in views), np.int64, count=n)
    PERF.inc("batched_calls")
    PERF.inc("batched_bufs", n)
    PERF.inc("batched_bytes", int(lens.sum()))
    if n == 0:
        return np.zeros(0, np.uint32)
    if backend != "numpy":
        crcs = np.full(n, seed, np.uint32)
        PERF.inc("native_batches")
        # big buffers go by pointer table (no copy), small ones by one
        # C-level join (a memcpy beats many pointer-object conversions)
        if views is None and int(lens.sum()) >= 768 * n:
            native.crc32c_batch_native_ptrs(crcs, bufs, lens)
            return crcs
        if views is None:
            flat = np.frombuffer(b"".join(bufs), np.uint8)
        else:
            flat = views[0] if n == 1 else np.concatenate(views)
        offs = np.zeros(n + 1, np.uint64)
        np.cumsum(lens, out=offs[1:])
        native.crc32c_batch_native(crcs, flat, offs[:-1],
                                   offs[1:] - offs[:-1])
        return crcs
    PERF.inc("numpy_batches")
    if views is None:
        views = [np.frombuffer(b, np.uint8) for b in bufs]
    # bucket by power-of-two padded length so one huge buffer cannot
    # blow the padded matrix up to N x max(L)
    out = np.empty(n, np.uint32)
    classes: dict[int, list[int]] = {}
    for i, ln in enumerate(lens):
        classes.setdefault(_next_pow2(max(int(ln), 64)), []).append(i)
    for cap, idx in sorted(classes.items()):
        rows = np.zeros((len(idx), cap), np.uint8)
        for r, i in enumerate(idx):
            rows[r, :lens[i]] = views[i]
        out[idx] = _crc_rows_numpy(rows, lens[idx], seed)
    return out


def _check_backend(backend: str | None) -> None:
    if backend not in (None, "native", "numpy"):
        raise ValueError(f"unknown crc32c backend {backend!r}")


# -- device kernel K4 -------------------------------------------------------

# launches of K4, counted where the wrapper launches it
LAUNCHES = {"crc32c_chunks": 0}

# the span plan (csrc/crc32c.cu): a warp checksums a span of 512 * rounds
# bytes of a row; rounds is a power of two up to _MAX_ROUNDS, halved while a
# launch has fewer than _TARGET_ITEMS (row, span) items for the card's
# resident warps (~4,224 on an H100) to walk, or while half a span still
# covers the row
_ROUND = 512
_GAP = _ROUND - 4          # bytes between two 4-byte words of one stream
_MAX_ROUNDS = 32
_TARGET_ITEMS = 1 << 14
# a row whose start or end is not 16-byte aligned is covered from its end
# rounded up to 16 back to before its start rounded down: l + 30 bytes at most
_EDGE_SLACK = 31
_FOLD_SHIFTS = (4, 16, 32, 64, 128, 256)


def fused_enabled() -> bool:
    """Device-fused CRC allowed (CEPH_TPU_NO_FUSED_CRC gates it off)."""
    return not os.environ.get("CEPH_TPU_NO_FUSED_CRC")


def to_uint32(crcs) -> np.ndarray:
    """CRCs from a device or host tensor (int64 registers) or an array
    -> np.uint32, the reference's host type."""
    if isinstance(crcs, torch.Tensor):
        # lint: disable=device-path-host-sync -- the CRCs' one hop to the host
        crcs = crcs.cpu().numpy()
    return np.asarray(crcs).astype(np.uint32)


def crc_plan(n: int, l: int, aligned: bool = True) -> tuple[int, int]:
    """K4's split of n rows of l bytes: (rounds, spans).  Each row is
    ``spans`` spans of 512 * rounds bytes, ending at the row's end rounded
    up to 16 bytes; ``aligned`` says the rows start and end on 16 bytes,
    else the spans reach _EDGE_SLACK bytes further."""
    reach = l if aligned else l + _EDGE_SLACK
    rounds = _MAX_ROUNDS
    while rounds > 1 and (rounds // 2 * _ROUND >= reach or
                          n * -(-reach // (rounds * _ROUND)) < _TARGET_ITEMS):
        rounds //= 2
    return rounds, -(-reach // (rounds * _ROUND))


def _byte_tables(mat: np.ndarray) -> np.ndarray:
    """(4, 256) words: mat . (v << 8k) at [k, v], a matrix as 4 lookups."""
    v = np.arange(256, dtype=np.uint32)[None, :] \
        << (8 * np.arange(4, dtype=np.uint32))[:, None]
    return _mat_apply(mat, v)


@functools.lru_cache(maxsize=1)
def _fixed_consts() -> np.ndarray:
    """K4's constants that no plan changes: the step tables T'_m = M^508 .
    T_m (m < 4), the fold matrices M^4 and M^(16 * 2^i) as byte tables,
    and M^-(508 + z) for z < 16 as columns."""
    step = _mat_apply(_zeros_matrix(_GAP), _tables()[:4])
    folds = [_byte_tables(_zeros_matrix(a)) for a in _FOLD_SHIFTS]
    tails = [_mat_inv(_zeros_matrix(_GAP + z)) for z in range(16)]
    return np.concatenate([a.reshape(-1) for a in [step, *folds, *tails]])


@functools.lru_cache(maxsize=64)
def _consts(rounds: int, n_ladder: int, device: torch.device) -> torch.Tensor:
    """K4's constants for a plan: the fixed ones, then the ladder
    M^(512 * rounds * 2^i), i < n_ladder, that moves a span's register
    over the spans after it."""
    words = [_fixed_consts()]
    words += [_zeros_matrix((_ROUND * rounds) << i) for i in range(n_ladder)]
    return torch.from_numpy(
        np.concatenate(words).astype(np.uint32).view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _seed_term(l: int, seed: int) -> int:
    """M^l . seed: the seed's share of every CRC of l bytes, which K4's
    rows start from."""
    return int(_mat_apply(_zeros_matrix(l), seed))


def _load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with K4's C entries typed."""
    lib = _build.library(name)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crc32c_chunks.argtypes = [vp, ll, vp, ll, vp, ll, i, ll, vp, i, i, vp]
    lib.crc32c_chunks.restype = i
    lib.crc32c_config.argtypes = [i, vp]
    lib.crc32c_config.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _load("crc32c")


def kernel_config(device: torch.device) -> dict:
    """K4's registers, shared memory, resident blocks a SM and local
    memory bytes, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 4)()
    err = _lib().crc32c_config(device.index, info)
    if err:
        raise RuntimeError(f"crc32c_config failed with CUDA error {err}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), info))


def crc32c_chunks_plain(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """(N, l) uint8 -> (N,) int64 raw CRC32C registers: the reference's
    slice-by-8 loop, one step per 8 bytes with table gathers, then the
    byte table over l % 8.  The register is carried as an int32 bit
    pattern (every shift is masked)."""
    n, l = x.shape
    t = torch.from_numpy(_tables().view(np.int32)).to(x.device)
    crc = torch.full((n,), seed, dtype=torch.int64,
                     device=x.device).to(torch.int32)
    n8 = l // 8
    if n8:
        b = x[:, :8 * n8].reshape(n, n8, 8)
        col = [b[..., i].to(torch.int32) for i in range(8)]
        lo = col[0] | (col[1] << 8) | (col[2] << 16) | (col[3] << 24)
        # the hi word's four lookups do not depend on the register
        hic = t[3][col[4]] ^ t[2][col[5]] ^ t[1][col[6]] ^ t[0][col[7]]
        del b, col
        for j in range(n8):
            v = crc ^ lo[:, j]
            crc = (t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF]
                   ^ t[5][(v >> 16) & 0xFF] ^ t[4][(v >> 24) & 0xFF]
                   ^ hic[:, j])
    for j in range(8 * n8, l):
        crc = t[0][(crc ^ x[:, j].to(torch.int32)) & 0xFF] \
            ^ ((crc >> 8) & 0xFFFFFF)
    return crc.to(torch.int64) & 0xFFFFFFFF


def _rows(x: torch.Tensor) -> tuple[tuple, torch.Tensor]:
    """(..., l) uint8 -> (leading dims, contiguous (n, l) rows)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
        raise TypeError("crc32c_chunks takes a uint8 torch.Tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    lead, l = tuple(x.shape[:-1]), x.shape[-1]
    n = int(np.prod(lead, dtype=np.int64))
    return lead, x.reshape(n, l).contiguous()


def _launch(a: torch.Tensor, b: torch.Tensor | None,
            seed: int) -> torch.Tensor:
    """One K4 launch over the rows of (n_a, l) and, if given, (n_b, l)
    contiguous CUDA rows (n_a, l >= 1) -> (n_a + n_b,) int64 CRCs, which
    the kernel XORs into the low words of the seed's share."""
    dev, l = a.device, a.shape[1]
    nb = 0 if b is None else b.shape[0]
    n = a.shape[0] + nb
    aligned = l % 16 == 0 and a.data_ptr() % 16 == 0 and (
        b is None or b.data_ptr() % 16 == 0)
    rounds, spans = crc_plan(n, l, aligned)
    n_ladder = (spans - 1).bit_length()
    consts = _consts(rounds, n_ladder, dev)
    out = torch.full((n,), _seed_term(l, seed), dtype=torch.int64, device=dev)
    err = _lib().crc32c_chunks(
        a.data_ptr(), a.shape[0], b.data_ptr() if nb else None, nb,
        out.data_ptr(), l, rounds, spans, consts.data_ptr(), n_ladder,
        dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(
            f"crc32c_chunks: kernel launch failed with CUDA error {err}")
    LAUNCHES["crc32c_chunks"] += 1
    return out


def crc32c_chunks(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """(..., l) uint8 -> (...,) int64 CRC32C of each row, raw register
    (no final XOR) from ``seed``: K4 on a CUDA tensor, the plain version
    on a CPU tensor.  l == 0 gives the seed without a launch.  No
    counters: the fused codec paths call this inside their launch."""
    lead, flat = _rows(x)
    n, l = flat.shape
    if l == 0 or n == 0:
        return torch.full(lead, seed, dtype=torch.int64, device=x.device)
    if x.device.type == "cpu":
        return crc32c_chunks_plain(flat, seed).reshape(lead)
    return _launch(flat, None, seed).reshape(lead)


def crc32c_chunks_pair(x: torch.Tensor, y: torch.Tensor,
                       seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    """``crc32c_chunks`` of x and of y, rows of one length on one device:
    one K4 launch for both on CUDA (a fused encode's data and parity)."""
    (lead_x, fx), (lead_y, fy) = _rows(x), _rows(y)
    if x.device != y.device or fx.shape[1] != fy.shape[1]:
        raise ValueError("crc32c_chunks_pair takes rows of one length on "
                         "one device")
    if x.device.type == "cpu" or 0 in (fx.shape[1], fx.shape[0], fy.shape[0]):
        return crc32c_chunks(x, seed), crc32c_chunks(y, seed)
    out = _launch(fx, fy, seed)
    return (out[:fx.shape[0]].reshape(lead_x),
            out[fx.shape[0]:].reshape(lead_y))


def crc32c_device_chunks(x, device=None) -> torch.Tensor:
    """(..., L) uint8 (numpy array or tensor) -> (...,) chunk CRCs
    computed on the device: a tensor stays on its own device, a numpy
    array goes to ``device`` (default CUDA).  Returns a DEVICE tensor so
    the caller fetches it together with the parity of the same launch
    window."""
    if isinstance(x, torch.Tensor):
        xd = x if device is None else x.to(resolve_device(device))
    else:
        xd = torch.from_numpy(np.array(x, np.uint8)).to(resolve_device(device))
    out = crc32c_chunks(xd)
    PERF.inc("fused_launches")
    PERF.inc("fused_crcs", int(out.numel()))
    return out


def crc32c_resident(buf, device=None) -> int:
    """Whole-buffer CRC32C of a resident buffer as ONE device launch:
    the buffer splits into equal power-of-two chunks whose CRCs come
    back from the device kernel, the GF(2) fold combines them, and the
    inverse matrix strips the zero padding, with no host pass over the
    payload bytes.  ``buf`` is bytes-like, an array or a tensor (kept on
    its own device); anything else goes to ``device``."""
    if isinstance(buf, torch.Tensor):
        dev = buf.device if device is None else resolve_device(device)
        flat = buf.reshape(-1).to(device=dev, dtype=torch.uint8)
    else:
        arr = (np.frombuffer(buf, np.uint8)
               if isinstance(buf, (bytes, bytearray, memoryview))
               else np.asarray(buf, np.uint8).reshape(-1))
        flat = torch.from_numpy(np.array(arr)).to(resolve_device(device))
    n = flat.numel()
    if n == 0:
        return SEED
    # up to ~256 chunks; the fold is a linear scan of their registers
    chunk = max(64, _next_pow2(-(-n // 256)))
    pad = (-n) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    crcs = to_uint32(crc32c_device_chunks(flat.reshape(-1, chunk)))
    out = np.asarray(fold_chunk_crcs(crcs, chunk), np.uint32).reshape(1)
    if pad:
        out = crc32c_strip_zeros(out, pad)
    PERF.inc("resident_crcs")
    return int(out[0])


def crc32c_resident_batch(views) -> np.ndarray:
    """Whole-buffer CRC32Cs of resident buffers, uint8 tensors on one
    device, in ONE K4 launch: the views are stacked into rows zero-padded
    to the longest, and the GF(2) inverse zero matrix strips each row's
    padding on the host (``crc32c_strip_zeros``).  No host pass over the
    payload bytes: what ``crc32c_resident`` does for one shard, for a
    scrub's whole sweep.  Returns (N,) np.uint32."""
    views = list(views)
    if not views:
        return np.zeros(0, np.uint32)
    lens = np.fromiter((v.numel() for v in views), np.int64, count=len(views))
    rows = torch.nn.utils.rnn.pad_sequence(
        [v.reshape(-1) for v in views], batch_first=True)
    crcs = to_uint32(crc32c_device_chunks(rows))
    pad = rows.shape[1] - lens
    if pad.any():
        crcs = crc32c_strip_zeros(crcs, pad)
    PERF.inc("resident_crcs", len(views))
    return crcs
