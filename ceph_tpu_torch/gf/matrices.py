"""Erasure-code generator and decode matrices (ISA-L constructions).

Byte-identical parity requires byte-identical matrices: these mirror
ISA-L's gf_gen_rs_matrix / gf_gen_cauchy1_matrix and its decode path
(first k surviving shards, inverted survivor matrix).
"""

from __future__ import annotations

import numpy as np

from .gf8 import GF_MUL_TABLE, gf_mul, gf_inv, gf_invert_matrix, gf_pow


def gen_rs_matrix(m: int, k: int) -> np.ndarray:
    """ISA-L systematic Vandermonde generator: (m, k), m = k + parity.

    Rows 0..k-1 are the identity; parity row r (row k+r) is
    [g^0, g^1, ..., g^(k-1)] with g = 2^r.
    """
    a = np.zeros((m, k), dtype=np.uint8)
    a[np.arange(k), np.arange(k)] = 1
    gen = 1
    for i in range(k, m):
        p = 1
        for j in range(k):
            a[i, j] = p
            p = gf_mul(p, gen)
        gen = gf_mul(gen, 2)
    return a


def gen_cauchy1_matrix(m: int, k: int) -> np.ndarray:
    """ISA-L Cauchy generator: identity on top, then 1/(i ^ j)."""
    a = np.zeros((m, k), dtype=np.uint8)
    a[np.arange(k), np.arange(k)] = 1
    for i in range(k, m):
        for j in range(k):
            a[i, j] = gf_inv(i ^ j)
    return a


def _jerasure_extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """jerasure's extended Vandermonde matrix (w=8).

    Row 0 = e_0, last row = e_{cols-1}; interior row i has entries i^j
    (GF power), matching reed_sol_extended_vandermonde_matrix semantics.
    """
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[0, 0] = 1
    for i in range(1, rows - 1):
        for j in range(cols):
            v[i, j] = gf_pow(i, j)
    v[rows - 1, cols - 1] = 1
    return v


def gen_jerasure_rs_vandermonde(k: int, m: int) -> np.ndarray:
    """jerasure reed_sol_van coding matrix: (m, k) parity rows.

    Reproduces reed_sol_big_vandermonde_distribution_matrix's distinguished
    matrix: build the (k+m, k) extended Vandermonde matrix, systematize the
    top k x k block with row swaps + column operations, then normalize so
    the first parity row and the first parity column are all ones.
    """
    rows, cols = k + m, k
    v = _jerasure_extended_vandermonde(rows, cols)
    for i in range(1, cols):
        # find a row at/below i with a nonzero pivot in column i, swap up
        piv = i
        while piv < rows and v[piv, i] == 0:
            piv += 1
        if piv >= rows:
            raise ValueError("vandermonde systematization failed")
        if piv != i:
            v[[i, piv]] = v[[piv, i]]
        # scale column i so the pivot is 1
        if v[i, i] != 1:
            inv = gf_inv(int(v[i, i]))
            v[:, i] = GF_MUL_TABLE[inv][v[:, i]]
        # clear the rest of row i with column ops
        for j in range(cols):
            c = int(v[i, j])
            if j != i and c != 0:
                v[:, j] ^= GF_MUL_TABLE[c][v[:, i]]
    # make parity row 0 (matrix row k) all ones by scaling the parity part
    # of each column
    for j in range(cols):
        c = int(v[k, j])
        if c != 1:
            inv = gf_inv(c)
            v[k:, j] = GF_MUL_TABLE[inv][v[k:, j]]
    # make parity column 0 all ones by scaling each later parity row
    for i in range(k + 1, rows):
        c = int(v[i, 0])
        if c not in (0, 1):
            inv = gf_inv(c)
            v[i] = GF_MUL_TABLE[inv][v[i]]
    return v[k:, :].copy()


def erasure_signature(decode_index: list[int], erasures: list[int]) -> str:
    """Decode-table cache key: "+r" per source row, "-e" per erasure."""
    return "".join(f"+{r}" for r in decode_index) + "".join(
        f"-{e}" for e in erasures)


def decode_index_for(k: int, erasures: set[int]) -> list[int]:
    """First k surviving shard indices, in order."""
    out = []
    r = 0
    for _ in range(k):
        while r in erasures:
            r += 1
        out.append(r)
        r += 1
    return out


def build_decode_matrix(
    encode_matrix: np.ndarray,
    k: int,
    erasures: list[int],
) -> tuple[np.ndarray, list[int]]:
    """The (nerrs, k) decode matrix over the first k surviving shards.

    Invert the k x k survivor rows of the generator; an erased data shard e
    takes row e of the inverse, an erased parity shard p takes (generator
    row p) @ inverse.  Returns (decode_matrix, decode_index).
    """
    decode_index = decode_index_for(k, set(erasures))
    d = gf_invert_matrix(encode_matrix[decode_index, :k])
    c = np.zeros((len(erasures), k), dtype=np.uint8)
    for p, e in enumerate(erasures):
        if e < k:
            c[p] = d[e]
        else:
            for i in range(k):
                s = 0
                for j in range(k):
                    s ^= gf_mul(int(d[j, i]), int(encode_matrix[e, j]))
                c[p, i] = s
    return c, decode_index
