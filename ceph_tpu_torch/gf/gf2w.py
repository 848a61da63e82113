"""GF(2^w) scalar arithmetic + GF(2) bitmatrix construction.

The jerasure bit-matrix techniques (cauchy_orig/cauchy_good/liberation/
blaum_roth) never do field multiplies on the data path -- coding is
pure XOR of w-bit packet rows selected by a (m*w, k*w) GF(2) matrix.
Field arithmetic is only needed to CONSTRUCT matrices, so plain Python
ints suffice (w up to 32).  Polynomials match jerasure's galois.c
defaults so the matrices are the reference's matrices:
w=4: 0x13, w=8: 0x11d, w=16: 0x1100b, w=32: 0x100400007.

Port of ``ceph_tpu/gf/gf2w.py``: host code, numpy and Python ints.
"""

from __future__ import annotations

import numpy as np

PRIM_POLY = {4: 0x13, 8: 0x11d, 16: 0x1100b, 32: 0x100400007}


def gf2w_mult(a: int, b: int, w: int) -> int:
    poly = PRIM_POLY[w]
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> w:
            a ^= poly
    return r


def gf2w_div(a: int, b: int, w: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF division by zero")
    return gf2w_mult(a, gf2w_inv(b, w), w)


def gf2w_inv(a: int, w: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF inverse of zero")
    # a^(2^w - 2) by square-and-multiply
    r, e = 1, (1 << w) - 2
    base = a
    while e:
        if e & 1:
            r = gf2w_mult(r, base, w)
        base = gf2w_mult(base, base, w)
        e >>= 1
    return r


def matrix_to_bitmatrix(matrix: np.ndarray, k: int, m: int,
                        w: int) -> np.ndarray:
    """(m,k) GF(2^w) matrix -> (m*w, k*w) GF(2) matrix.

    jerasure_matrix_to_bitmatrix semantics: the w x w block for element
    e has column c equal to the bit-decomposition of e * alpha^c
    (successive columns multiply by 2)."""
    out = np.zeros((m * w, k * w), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            e = int(matrix[i, j])
            b = e
            for c in range(w):
                for r in range(w):
                    out[i * w + r, j * w + c] = (b >> r) & 1
                b = gf2w_mult(b, 2, w)
    return out


def bitmatrix_ones(row: np.ndarray) -> int:
    return int(row.sum())


# -- cauchy (jerasure cauchy.c semantics) -----------------------------------

def cauchy_original_coding_matrix(k: int, m: int, w: int) -> np.ndarray:
    """matrix[i][j] = 1 / (i XOR (m + j)) over GF(2^w)."""
    if k + m > (1 << w):
        raise ValueError(f"k+m={k + m} > 2^w={1 << w}")
    out = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            out[i, j] = gf2w_inv(i ^ (m + j), w)
    return out


def cauchy_improve_coding_matrix(matrix: np.ndarray, k: int, m: int,
                                 w: int) -> np.ndarray:
    """cauchy_good's matrix optimization: normalize each column so row
    0 is all ones, then rescale each later row by the divisor that
    minimizes the total number of ones in its bitmatrix (fewer ones =
    fewer XORs on the data path)."""
    mat = matrix.copy()
    for j in range(k):
        d = int(mat[0, j])
        if d != 1:
            inv = gf2w_inv(d, w)
            for i in range(m):
                mat[i, j] = gf2w_mult(int(mat[i, j]), inv, w)
    for i in range(1, m):
        best_div = 1
        best = sum(_elt_ones(int(e), w) for e in mat[i])
        for j in range(k):
            d = int(mat[i, j])
            if d in (0, 1):
                continue
            inv = gf2w_inv(d, w)
            cand = [gf2w_mult(int(e), inv, w) for e in mat[i]]
            ones = sum(_elt_ones(e, w) for e in cand)
            if ones < best:
                best = ones
                best_div = d
        if best_div != 1:
            inv = gf2w_inv(best_div, w)
            for j in range(k):
                mat[i, j] = gf2w_mult(int(mat[i, j]), inv, w)
    return mat


def _elt_ones(e: int, w: int) -> int:
    """Number of ones in the w x w bitmatrix block of element e."""
    ones = 0
    b = e
    for _ in range(w):
        ones += bin(b).count("1")
        b = gf2w_mult(b, 2, w)
    return ones


# -- liberation / blaum-roth (minimal-density RAID-6 bitmatrices) ------------

def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def liberation_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation codes (Plank): m=2, w prime, k <= w.

    P row: identity per chunk.  Q row: for chunk j a shifted identity
    (one at (i, (i+j) mod w)) plus, for j>0, one extra bit at row
    i = j*(w-1)/2 mod w, column (i + j - 1) mod w (liberation.c)."""
    if not _is_prime(w):
        raise ValueError(f"liberation requires prime w, got {w}")
    if k > w:
        raise ValueError(f"liberation requires k <= w ({k} > {w})")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        off = j * w
        for i in range(w):
            bm[i, off + i] = 1                       # P (RAID-4 row)
            bm[w + i, off + (i + j) % w] = 1         # Q shifted identity
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            bm[w + i, off + (i + j - 1) % w] = 1     # the extra bit
    return bm


def blaum_roth_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth codes: m=2, w+1 prime, k <= w.

    Arithmetic in the ring F2[x]/M_p(x), p = w+1 prime, where
    M_p = 1 + x + ... + x^(p-1): the Q block for chunk j is the
    multiplication-by-x^j matrix in the basis {1..x^(w-1)} (with
    x^w == 1 + x + ... + x^(w-1)); P is plain parity."""
    p = w + 1
    if not _is_prime(p):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w ({k} > {w})")

    def mult_by_x(vec: np.ndarray) -> np.ndarray:
        out = np.zeros(w, dtype=np.uint8)
        out[1:] = vec[:-1]
        if vec[w - 1]:                  # x^w = sum_{i<w} x^i
            out ^= 1
        return out

    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        off = j * w
        for i in range(w):
            bm[i, off + i] = 1                       # P
        # Q block: columns are x^j * basis vectors
        for c in range(w):
            vec = np.zeros(w, dtype=np.uint8)
            vec[c] = 1
            for _ in range(j):
                vec = mult_by_x(vec)
            bm[w:2 * w, off + c] = vec
    return bm


# -- GF(2) linear algebra on the data path ----------------------------------

def xor_matmul(bits: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """(r, c) 0/1 matrix x (c, N) byte rows -> (r, N), + = XOR.

    XOR of byte vectors is addition in GF(2)^8 componentwise, so this
    is the whole bitmatrix data path, on the host."""
    out = np.zeros((bits.shape[0], planes.shape[1]), dtype=np.uint8)
    for r in range(bits.shape[0]):
        sel = planes[bits[r] != 0]
        if len(sel):
            out[r] = np.bitwise_xor.reduce(sel, axis=0)
    return out


def gf2_invert(mat: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2); raises on singular."""
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("bitmatrix singular")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv
