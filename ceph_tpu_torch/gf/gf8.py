"""GF(2^8) table-based arithmetic (numpy, host side).

The host oracle of the port: the CUDA kernels in ``ceph_tpu_torch.ops``
compute the same field products as GF(2) bit-matrix multiplications and
must agree with ``gf_matmul`` byte for byte.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (poly 0x11d), the field
of ISA-L erasure coding and jerasure w=8.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= GF_POLY
    # replicate so exp[log a + log b] never needs a mod
    exp[255:510] = exp[:255]
    exp[510:] = exp[:2]
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# full 256x256 multiplication table: GF_MUL_TABLE[a, b] = a*b
GF_MUL_TABLE = GF_EXP[GF_LOG[:, None] + GF_LOG[None, :]]
GF_MUL_TABLE[0, :] = 0
GF_MUL_TABLE[:, 0] = 0

GF_INV = np.zeros(256, dtype=np.uint8)
GF_INV[1:] = GF_EXP[255 - GF_LOG[1:]]


def gf_mul(a: int, b: int) -> int:
    """Scalar product in GF(2^8)."""
    return int(GF_MUL_TABLE[a & 0xFF, b & 0xFF])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_INV[a])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_matmul(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """GF(2^8) product of an (r,k) coefficient matrix with (k,n) bytes.

    out[i, :] = XOR_j  mat[i, j] * data[j, :]   (ISA-L's ec_encode_data)
    """
    mat = np.asarray(mat, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    r, k = mat.shape
    if data.shape[0] != k:
        raise ValueError(f"matrix {mat.shape} does not match data {data.shape}")
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(k):
            c = mat[i, j]
            if c == 1:
                acc ^= data[j]
            elif c:
                acc ^= GF_MUL_TABLE[c][data[j]]
    return out


def gf_invert_matrix(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan; ValueError if singular."""
    mat = np.array(mat, dtype=np.uint8, copy=True)
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"not a square matrix: {mat.shape}")
    aug = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.flatnonzero(aug[col:, col])
        if nz.size == 0:
            raise ValueError("singular GF(2^8) matrix")
        pivot = col + int(nz[0])
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = GF_MUL_TABLE[GF_INV[aug[col, col]]][aug[col]]
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= GF_MUL_TABLE[aug[row, col]][aug[col]]
    return aug[:, n:].copy()


def gf_solve_rows(src_rows: np.ndarray,
                  target_rows: np.ndarray) -> np.ndarray:
    """Express ``target_rows`` as GF(2^8) combinations of ``src_rows``.

    Solves X @ src_rows = target_rows for X (t, s) given src_rows (s, q) and
    target_rows (t, q); src_rows need not be square or full rank, only the
    targets must lie in their row span.  The linear codecs build every
    repair matrix with it: an LRC local-group repair and a flat decode are
    both "write the lost rows over the rows read".  Raises ValueError when a
    target is outside the span.

    Free variables are pinned to zero, so the same (sources, targets) always
    give the same matrix (a stable schedule key).
    """
    src = np.array(src_rows, dtype=np.uint8, copy=True)
    tgt = np.asarray(target_rows, dtype=np.uint8)
    s, q = src.shape
    t = tgt.shape[0]
    assert tgt.shape[1] == q, (src.shape, tgt.shape)
    # row-reduce [src | I_s]: record each pivot column; the identity side
    # accumulates the combination that produced each reduced row
    aug = np.concatenate([src, np.eye(s, dtype=np.uint8)], axis=1)
    pivots: list[tuple[int, int]] = []      # (row, column)
    row = 0
    for col in range(q):
        piv = -1
        for r2 in range(row, s):
            if aug[r2, col]:
                piv = r2
                break
        if piv < 0:
            continue
        if piv != row:
            aug[[row, piv]] = aug[[piv, row]]
        inv = GF_INV[aug[row, col]]
        aug[row] = GF_MUL_TABLE[inv][aug[row]]
        for r2 in range(s):
            if r2 != row and aug[r2, col]:
                aug[r2] ^= GF_MUL_TABLE[aug[r2, col]][aug[row]]
        pivots.append((row, col))
        row += 1
        if row == s:
            break
    out = np.zeros((t, s), dtype=np.uint8)
    for i in range(t):
        residue = np.array(tgt[i], copy=True)
        combo = np.zeros(s, dtype=np.uint8)
        for prow, pcol in pivots:
            c = residue[pcol]
            if c:
                residue ^= GF_MUL_TABLE[c][aug[prow, :q]]
                combo ^= GF_MUL_TABLE[c][aug[prow, q:]]
        if residue.any():
            raise ValueError(
                "target row outside the span of the source rows "
                "(erasure pattern not recoverable from these sources)")
        out[i] = combo
    return out


# ---------------------------------------------------------------------------
# GF(2) bit-matrix form: multiplication by a constant c is linear over GF(2),
# so with a byte as its 8 coefficient bits (bit i = coefficient of x^i) there
# is an 8x8 binary M_c with bits(c*d) = M_c @ bits(d) (mod 2), and an (r,k)
# coefficient matrix becomes an (8r, 8k) binary matrix.
# ---------------------------------------------------------------------------

def coeff_to_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by ``c``; column t = bits of c*x^t."""
    prods = GF_MUL_TABLE[c & 0xFF][1 << np.arange(8)]          # c * x^t
    return ((prods[None, :] >> np.arange(8)[:, None]) & 1).astype(np.uint8)


def matrix_to_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """(r,k) coefficient matrix -> (8r,8k) GF(2) matrix.

    Row 8i+s is output bit s of row i; column 8j+t is bit t of chunk j.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = coeff_to_bitmatrix(mat[i, j])
    return out
