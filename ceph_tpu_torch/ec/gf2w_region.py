"""GF(2^16)/GF(2^32) word-region arithmetic for jerasure w=16/32.

The reference's jerasure word techniques at w=16/32 treat each chunk
as little-endian w-bit words and run the coding matrix over GF(2^w)
(jerasure_matrix_encode -> galois_w16/w32_region_mult, galois.c).
A region multiply by a CONSTANT c decomposes by byte: for data word
d = sum_i b_i << 8i,

    c * d  =  XOR_i  T_c,i[b_i]     with  T_c,i[x] = c * (x << 8i)

so the whole region is w/8 table lookups + XORs -- exactly the split
multiplication galois.c uses for w=32 (and a valid one for w=16),
rendered as numpy gathers.  Field polynomials match galois.c
(gf/gf2w.py PRIM_POLY), so the words are the reference's words.

Matrix construction and inversion run in plain ints via gf2w_mult;
the decode path mirrors gf/matrices.py build_decode_matrix over the
wider field.

Port of ``ceph_tpu/ec/gf2w_region.py``: host code (numpy).
"""

from __future__ import annotations

import functools

import numpy as np

from ..gf.gf2w import gf2w_inv, gf2w_mult

_DTYPE = {16: np.uint16, 32: np.uint32}


@functools.lru_cache(maxsize=4096)
def _mult_tables(c: int, w: int) -> tuple:
    """w/8 tables of 256 words: T_i[x] = c * (x << 8i) in GF(2^w)."""
    out = []
    for i in range(w // 8):
        t = np.zeros(256, dtype=_DTYPE[w])
        for x in range(256):
            t[x] = gf2w_mult(c, x << (8 * i), w)
        out.append(t)
    return tuple(out)


def region_mult(c: int, data: np.ndarray, w: int) -> np.ndarray:
    """Multiply a region of w-bit words by the constant ``c``."""
    words = data.view(_DTYPE[w])
    if c == 0:
        return np.zeros_like(words)
    if c == 1:
        return words.copy()
    tables = _mult_tables(c, w)
    out = tables[0][words & 0xFF]
    for i in range(1, w // 8):
        out ^= tables[i][(words >> (8 * i)) & 0xFF]
    return out


def gf2w_matmul(matrix: np.ndarray, data: np.ndarray,
                w: int) -> np.ndarray:
    """(r,k) GF(2^w) matrix x (k, n_bytes) byte rows -> (r, n_bytes).

    Rows are viewed as little-endian w-bit words (chunk sizes are
    w-aligned by get_alignment)."""
    r, k = matrix.shape
    rows = [region_mult_rows(matrix[i], data, w) for i in range(r)]
    return np.stack(rows).view(np.uint8).reshape(r, data.shape[1])


def region_mult_rows(coeffs, data: np.ndarray, w: int) -> np.ndarray:
    acc = None
    for j, c in enumerate(coeffs):
        prod = region_mult(int(c), data[j], w)
        acc = prod if acc is None else acc ^ prod
    return acc


def gf2w_invert_matrix(a: np.ndarray, w: int) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^w); raises ValueError if
    singular."""
    n = a.shape[0]
    m = [[int(v) for v in row] for row in a]
    inv = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            m[col], m[piv] = m[piv], m[col]
            inv[col], inv[piv] = inv[piv], inv[col]
        pinv = gf2w_inv(m[col][col], w)
        m[col] = [gf2w_mult(v, pinv, w) for v in m[col]]
        inv[col] = [gf2w_mult(v, pinv, w) for v in inv[col]]
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [v ^ gf2w_mult(f, p, w)
                        for v, p in zip(m[r], m[col])]
                inv[r] = [v ^ gf2w_mult(f, p, w)
                          for v, p in zip(inv[r], inv[col])]
    return np.array(inv, dtype=_DTYPE[w])


def build_decode_matrix_w(encode_matrix: np.ndarray, k: int,
                          erasures: list[int],
                          w: int) -> tuple[np.ndarray, list[int]]:
    """build_decode_matrix over GF(2^w) (gf/matrices.py:131 widened)."""
    from ..gf.matrices import decode_index_for
    eset = set(erasures)
    decode_index = decode_index_for(k, eset)
    b = encode_matrix[decode_index, :k]
    d = gf2w_invert_matrix(b, w)
    c = np.zeros((len(erasures), k), dtype=_DTYPE[w])
    for p, e in enumerate(erasures):
        if e < k:
            c[p] = d[e]
        else:
            for i in range(k):
                s = 0
                for j in range(k):
                    s ^= gf2w_mult(int(d[j, i]),
                                   int(encode_matrix[e, j]), w)
                c[p, i] = s
    return c, decode_index


# -- generator matrices over GF(2^w) (jerasure constructions) ---------------

def gen_rs_vandermonde_w(k: int, m: int, w: int) -> np.ndarray:
    """reed_sol_van coding rows over GF(2^w): the jerasure
    distinguished Vandermonde (reed_sol.c) widened from the w=8
    rendering in gf/matrices.py."""
    rows, cols = k + m, k
    v = [[0] * cols for _ in range(rows)]
    v[0][0] = 1
    for i in range(1, rows - 1):
        p = 1
        for j in range(cols):
            v[i][j] = p
            p = gf2w_mult(p, i, w)
    v[rows - 1][cols - 1] = 1
    for i in range(1, cols):
        piv = i
        while piv < rows and v[piv][i] == 0:
            piv += 1
        if piv >= rows:
            raise ValueError("vandermonde systematization failed")
        if piv != i:
            v[i], v[piv] = v[piv], v[i]
        if v[i][i] != 1:
            inv = gf2w_inv(v[i][i], w)
            for r in range(rows):
                v[r][i] = gf2w_mult(v[r][i], inv, w)
        for j in range(cols):
            c = v[i][j]
            if j != i and c != 0:
                for r in range(rows):
                    v[r][j] ^= gf2w_mult(c, v[r][i], w)
    for j in range(cols):
        c = v[k][j]
        if c != 1:
            inv = gf2w_inv(c, w)
            for r in range(k, rows):
                v[r][j] = gf2w_mult(v[r][j], inv, w)
    for i in range(k + 1, rows):
        c = v[i][0]
        if c not in (0, 1):
            inv = gf2w_inv(c, w)
            v[i] = [gf2w_mult(x, inv, w) for x in v[i]]
    return np.array([row for row in v[k:]], dtype=_DTYPE[w])


def gen_raid6_w(k: int, w: int) -> np.ndarray:
    """reed_sol_r6_op rows over GF(2^w): [1,1,...] and [1,2,4,...]."""
    coding = np.zeros((2, k), dtype=_DTYPE[w])
    coding[0, :] = 1
    p = 1
    for j in range(k):
        coding[1, j] = p
        p = gf2w_mult(p, 2, w)
    return coding
