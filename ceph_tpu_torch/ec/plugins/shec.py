"""SHEC: Shingled Erasure Code (space-efficiency vs recovery-I/O knob).

Decision-level rendering of src/erasure-code/shec/ErasureCodeShec.cc:

  * matrix (shec_reedsolomon_coding_matrix, :465-533): start from the
    jerasure Vandermonde coding matrix, then zero a cyclic window of
    each parity row so parity rr covers only its "shingle"; the
    multiple-technique variant splits (m, c) into (m1, c1)+(m2, c2)
    minimizing recovery efficiency r_e1 (:424-460).
  * decode (shec_make_decoding_matrix, :535-763): exhaustive search
    over parity subsets for the SMALLEST square system (dup rows =
    dup columns, determinant != 0) that recovers the wanted erased
    data chunks -- this is what makes single-failure recovery read
    fewer than k chunks, SHEC's selling point.
  * minimum_to_decode returns exactly the rows of that system.

k+m may exceed what MDS codes allow to recover: SHEC trades
recoverability of some multi-erasure patterns for locality (the test
suite asserts both directions).

Port of ``ceph_tpu/ec/plugins/shec.py``: host code (numpy GF(2^8)); the
factory takes the registry's ``device`` and ignores it.
"""

from __future__ import annotations

from itertools import combinations
from typing import Mapping

import numpy as np

from ..base import ErasureCode
from ..registry import ErasureCodePlugin
from ...gf import gen_jerasure_rs_vandermonde, gf_matmul
from ...gf.gf8 import gf_invert_matrix

LARGEST_VECTOR_WORDSIZE = 16


class ErasureCodeShec(ErasureCode):
    technique = "multiple"

    def __init__(self) -> None:
        super().__init__()
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = 8
        self.matrix: np.ndarray | None = None    # (m, k) coding rows

    # -- profile ------------------------------------------------------------
    def init(self, profile) -> None:
        self.parse(profile)
        self.k = self.to_int("k", profile, "4")
        self.m = self.to_int("m", profile, "3")
        self.c = self.to_int("c", profile, "2")
        self.w = self.to_int("w", profile, "8")
        if self.w != 8:
            # the SHEC coding matrix and all encode/decode math here
            # are GF(2^8); accepting w=16/32 would produce chunks that
            # are self-consistent but NOT the reference's w=16/32
            # encodings, and without the larger field's recoverability
            # -- refuse loudly instead
            raise ValueError(
                f"shec: w={self.w} unsupported (GF(2^8) only; "
                f"use jerasure for w=16/32 word techniques)")
        if not 1 <= self.c <= self.m:
            raise ValueError(f"shec: need 1 <= c={self.c} <= m={self.m}")
        if self.k < 1 or self.m < 1:
            raise ValueError("shec: k and m must be >= 1")
        self.matrix = self._coding_matrix(
            single=self.technique == "single")
        super().init(profile)

    def _shingle_windows(self, m1: int, m2: int, c1: int,
                         c2: int) -> list[tuple[int, int]]:
        """Per-parity (start, end) of the ZEROED window (cyclic)."""
        out = []
        for rr in range(m1):
            end = ((rr * self.k) // m1) % self.k
            start = (((rr + c1) * self.k) // m1) % self.k
            out.append((start, end))
        for rr in range(m2):
            end = ((rr * self.k) // m2) % self.k
            start = (((rr + c2) * self.k) // m2) % self.k
            out.append((start, end))
        return out

    def _recovery_efficiency1(self, m1: int, m2: int, c1: int,
                              c2: int) -> float:
        """shec_calc_recovery_efficiency1: total shingle width."""
        if m1 < c1 or m2 < c2:
            return -1
        if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
            return -1
        r_e1 = 0
        for rr in range(m1):
            r_e1 += ((rr + c1) * self.k) // m1 - (rr * self.k) // m1
        for rr in range(m2):
            r_e1 += ((rr + c2) * self.k) // m2 - (rr * self.k) // m2
        return r_e1

    def _coding_matrix(self, single: bool) -> np.ndarray:
        k, m, c = self.k, self.m, self.c
        if single:
            m1, c1 = 0, 0
        else:
            best, m1, c1 = None, 0, 0
            for c1_try in range(c // 2 + 1):
                for m1_try in range(m + 1):
                    c2 = c - c1_try
                    m2 = m - m1_try
                    if m1_try < c1_try or m2 < c2:
                        continue
                    if (m1_try == 0) != (c1_try == 0):
                        continue
                    if (m2 == 0) != (c2 == 0):
                        continue
                    r = self._recovery_efficiency1(m1_try, m2, c1_try, c2)
                    if r >= 0 and (best is None or r < best):
                        best, m1, c1 = r, m1_try, c1_try
        m2, c2 = m - m1, c - c1
        matrix = gen_jerasure_rs_vandermonde(k, m).astype(np.uint8)
        for rr, (start, end) in enumerate(
                self._shingle_windows(m1, m2, c1, c2)):
            cc = start
            while cc != end:
                matrix[rr, cc] = 0
                cc = (cc + 1) % k
        return matrix

    # -- geometry -----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        alignment = self.k * self.w * 4
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        return padded // self.k

    # -- decoding-system search (shec_make_decoding_matrix) ------------------
    def _search_decoding_system(self, want: set[int],
                                avails: set[int]):
        """Smallest square system recovering wanted erased data.

        Returns (dm_rows, dm_columns, inverse | None, minimum_set) or
        raises IOError when unrecoverable."""
        k, m = self.k, self.m
        want = set(want)
        # wanted-but-lost parity pulls in the data chunks it covers
        for i in range(m):
            if (k + i) in want and (k + i) not in avails:
                want |= {j for j in range(k) if self.matrix[i, j]}
        best = None          # (dup, ek, rows, cols)
        for ek in range(m + 1):
            if best is not None and best[1] <= ek and best[0] < k + 1:
                break
            for parities in combinations(range(m), ek):
                if any((k + p) not in avails for p in parities):
                    continue
                cols = {i for i in range(k)
                        if i in want and i not in avails}
                rows = set()
                for p in parities:
                    rows.add(k + p)
                    for j in range(k):
                        if self.matrix[p, j]:
                            cols.add(j)
                            if j in avails:
                                rows.add(j)
                if len(rows) != len(cols):
                    continue
                dup = len(rows)
                if best is not None and dup >= best[0]:
                    continue
                if dup == 0:
                    best = (0, ek, [], [])
                    break
                rs, cs = sorted(rows), sorted(cols)
                sub = np.zeros((dup, dup), dtype=np.uint8)
                for ri, r in enumerate(rs):
                    for ci, c2 in enumerate(cs):
                        sub[ri, ci] = (1 if r < k and r == c2 else
                                       0 if r < k else
                                       self.matrix[r - k, c2])
                try:
                    gf_invert_matrix(sub)
                except ValueError:
                    continue
                best = (dup, ek, rs, cs)
            if best is not None and best[0] == 0:
                break
        if best is None:
            raise IOError("shec: no recovery system for this pattern")
        dup, ek, rs, cs = best
        minimum = set(rs)
        for i in range(k):
            if i in want and i in avails:
                minimum.add(i)
        for i in range(m):
            if (k + i) in want and (k + i) in avails \
                    and (k + i) not in minimum:
                if any(self.matrix[i, j] and j not in want
                       for j in range(k)):
                    minimum.add(k + i)
        return dup, rs, cs, minimum

    def _minimum_to_decode(self, want_to_read: set[int],
                           available_chunks: set[int]) -> set[int]:
        _, _, _, minimum = self._search_decoding_system(
            set(want_to_read), set(available_chunks))
        return minimum

    def minimum_to_decode(self, want_to_read, available):
        minimum = self._minimum_to_decode(set(want_to_read),
                                          set(available))
        return {shard: [(0, 1)] for shard in sorted(minimum)}

    # minimum_to_decode_with_cost: inherited from ErasureCode -- the
    # cost-tier growth there calls back into this plugin's
    # _minimum_to_decode, so the decoding-system search still picks
    # the reads within the cheapest feasible candidate set.

    # -- data path -----------------------------------------------------------
    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([chunks[self.chunk_index(i)] for i in range(k)])
        parity = gf_matmul(self.matrix, data)
        for r in range(m):
            chunks[self.chunk_index(k + r)][:] = parity[r]

    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        avails = set(chunks)
        erased = [i for i in want_to_read if i not in avails]
        if not erased:
            return
        # only the WANTED chunks are recovered -- recovering from a
        # minimal subset is the point of the shingle (the reference's
        # shec_matrix_decode takes explicit want/avails the same way)
        want = set(want_to_read)
        dup, rs, cs, _ = self._search_decoding_system(want, avails)
        if dup:
            sub = np.zeros((dup, dup), dtype=np.uint8)
            for ri, r in enumerate(rs):
                for ci, c2 in enumerate(cs):
                    sub[ri, ci] = (1 if r < k and r == c2 else
                                   0 if r < k else
                                   self.matrix[r - k, c2])
            inv = gf_invert_matrix(sub)
            src = np.stack([decoded[r] for r in rs])
            out = gf_matmul(inv, src)
            for ci, c2 in enumerate(cs):
                if c2 not in avails:
                    decoded[c2][:] = out[ci]
        # re-encode wanted erased parity: only its COVERED data chunks
        # matter (zero coefficients ignore the rest), and those were
        # pulled into the system by the search's want expansion
        for i in range(m):
            if (k + i) in erased:
                rowsrc = np.stack([decoded[j] for j in range(k)])
                decoded[k + i][:] = gf_matmul(
                    self.matrix[i:i + 1], rowsrc)[0]


class ErasureCodeShecSingle(ErasureCodeShec):
    technique = "single"


def _factory(profile, device=None):
    # host codec: runs on the CPU whatever the caller's device
    technique = profile.get("technique", "multiple")
    if technique == "single":
        return ErasureCodeShecSingle()
    if technique == "multiple":
        return ErasureCodeShec()
    raise ValueError(f"shec: unknown technique {technique}")


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
