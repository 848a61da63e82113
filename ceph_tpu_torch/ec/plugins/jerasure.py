"""jerasure-semantics plugin: RS word techniques + bitmatrix techniques.

Mirrors the reference's jerasure plugin techniques
(src/erasure-code/jerasure/ErasureCodeJerasure.cc):

  * reed_sol_van  -- systematized extended-Vandermonde matrix
    (reed_sol_vandermonde_coding_matrix, ErasureCodeJerasure.cc:203)
  * reed_sol_r6_op -- RAID6 rows [1,1,..], [1,2,4,..] with m forced to 2
  * cauchy_orig   -- 1/(i ^ (m+j)) GF(2^w) Cauchy matrix expanded to a
    GF(2) bitmatrix (ErasureCodeJerasure.h:174, cauchy.c)
  * cauchy_good   -- same with the ones-minimizing matrix improvement
    (ErasureCodeJerasure.h:183)
  * liberation    -- minimal-density RAID-6 bitmatrix, w prime
    (ErasureCodeJerasure.h:192, liberation.c)
  * blaum_roth    -- RAID-6 over F2[x]/M_{w+1}(x), w+1 prime
    (ErasureCodeJerasure.h:229)

Bitmatrix techniques process chunks as regions of w packets of
``packetsize`` bytes; their whole data path is XOR (see
ec/bitmatrix_codec.py).  Chunk sizing follows
ErasureCodeJerasure::get_chunk_size (:80-104).

Port of ``ceph_tpu/ec/plugins/jerasure.py``: host code.  Every technique
runs on the host (``NumpyBackend``, ``GF2WBackend``, the bitmatrix codec's
``apply_host``); the factory takes the registry's ``device`` and ignores it.
"""

from __future__ import annotations

import numpy as np

from ..bitmatrix_codec import BitMatrixCodec
from ..rs_codec import RSMatrixCodec
from ..registry import ErasureCodePlugin
from ...gf import gen_jerasure_rs_vandermonde, gf_pow
from ...gf.gf2w import (
    blaum_roth_coding_bitmatrix, cauchy_improve_coding_matrix,
    cauchy_original_coding_matrix, liberation_coding_bitmatrix,
    matrix_to_bitmatrix,
)

LARGEST_VECTOR_WORDSIZE = 16

DEFAULT_K = "2"
DEFAULT_M = "1"
DEFAULT_W = "8"


class GF2WBackend:
    """Word-region matmul backend for the w=16/32 word techniques
    (galois_w16/w32_region_mult semantics, ec/gf2w_region.py), on the
    host."""

    def __init__(self, w: int) -> None:
        self.w = w
        self.name = f"gf2w{w}"

    def matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        from ..gf2w_region import gf2w_matmul
        return gf2w_matmul(matrix, data, self.w)


class ErasureCodeJerasure(RSMatrixCodec):
    technique = "reed_sol_van"
    DEFAULT_K = DEFAULT_K
    DEFAULT_M = DEFAULT_M

    def __init__(self, backend=None) -> None:
        super().__init__(backend=backend)
        self.w = 8
        self.per_chunk_alignment = False

    def _use_gf2w(self) -> bool:
        return self.w in (16, 32)

    def _build_decode_matrix(self, erasures):
        if self._use_gf2w():
            from ..gf2w_region import build_decode_matrix_w
            return build_decode_matrix_w(self.encode_matrix, self.k,
                                         erasures, self.w)
        return super()._build_decode_matrix(erasures)

    def get_alignment(self) -> int:
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4  # sizeof(int)
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = (stripe_width + self.k - 1) // self.k
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def parse_base(self, profile) -> None:
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, DEFAULT_W)
        self.sanity_check_k_m(self.k, self.m)
        if self.w not in (8, 16, 32):
            # reference resets to default with a notice (:154-160)
            self.w = 8
        if self._use_gf2w():
            # wide words: GF(2^w) region backend (the injected GF(2^8)
            # bit-matmul backend cannot serve these fields)
            self.backend = GF2WBackend(self.w)
        self.per_chunk_alignment = (
            str(profile.get("jerasure-per-chunk-alignment", "false")).lower()
            in ("true", "1", "yes"))

    def init(self, profile) -> None:
        self.parse(profile)
        self.parse_base(profile)
        self.prepare()
        super().init(profile)


class ErasureCodeJerasureReedSolomonVandermonde(ErasureCodeJerasure):
    technique = "reed_sol_van"
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def prepare(self) -> None:
        if self._use_gf2w():
            from ..gf2w_region import gen_rs_vandermonde_w, _DTYPE
            coding = gen_rs_vandermonde_w(self.k, self.m, self.w)
            ident = np.eye(self.k, dtype=_DTYPE[self.w])
            self.encode_matrix = np.concatenate([ident, coding], axis=0)
            return
        coding = gen_jerasure_rs_vandermonde(self.k, self.m)
        self.encode_matrix = np.concatenate(
            [np.eye(self.k, dtype=np.uint8), coding], axis=0)


class ErasureCodeJerasureReedSolomonRAID6(ErasureCodeJerasure):
    technique = "reed_sol_r6_op"
    DEFAULT_K = "7"
    DEFAULT_M = "2"

    def parse_base(self, profile) -> None:
        super().parse_base(profile)
        # RAID6 technique pins m=2 (ErasureCodeJerasure.h:111-128)
        self.m = 2

    def prepare(self) -> None:
        if self._use_gf2w():
            from ..gf2w_region import gen_raid6_w, _DTYPE
            coding = gen_raid6_w(self.k, self.w)
            ident = np.eye(self.k, dtype=_DTYPE[self.w])
            self.encode_matrix = np.concatenate([ident, coding], axis=0)
            return
        k = self.k
        coding = np.zeros((2, k), dtype=np.uint8)
        coding[0, :] = 1
        for j in range(k):
            coding[1, j] = gf_pow(2, j)
        self.encode_matrix = np.concatenate(
            [np.eye(k, dtype=np.uint8), coding], axis=0)


DEFAULT_PACKETSIZE = "2048"


class ErasureCodeJerasureBitMatrix(BitMatrixCodec):
    """Shared profile handling for the bitmatrix techniques."""

    technique = ""
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def parse_base(self, profile) -> None:
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        self.packetsize = self.to_int("packetsize", profile,
                                      DEFAULT_PACKETSIZE)
        if self.packetsize <= 0:
            raise ValueError(
                f"packetsize={self.packetsize} must be positive")
        if self.w <= 0:
            raise ValueError(f"w={self.w} must be positive")
        self.sanity_check_k_m(self.k, self.m)

    def init(self, profile) -> None:
        self.parse(profile)
        self.parse_base(profile)
        self.prepare()
        super().init(profile)


class ErasureCodeJerasureCauchyOrig(ErasureCodeJerasureBitMatrix):
    technique = "cauchy_orig"
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def _coding_matrix(self):
        return cauchy_original_coding_matrix(self.k, self.m, self.w)

    def prepare(self) -> None:
        self.bitmatrix = matrix_to_bitmatrix(
            self._coding_matrix(), self.k, self.m, self.w)


class ErasureCodeJerasureCauchyGood(ErasureCodeJerasureCauchyOrig):
    technique = "cauchy_good"

    def _coding_matrix(self):
        return cauchy_improve_coding_matrix(
            cauchy_original_coding_matrix(self.k, self.m, self.w),
            self.k, self.m, self.w)


class ErasureCodeJerasureLiberation(ErasureCodeJerasureBitMatrix):
    technique = "liberation"
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "7"

    def parse_base(self, profile) -> None:
        super().parse_base(profile)
        self.m = 2                  # RAID-6 family (ErasureCodeJerasure.h)

    def prepare(self) -> None:
        self.bitmatrix = liberation_coding_bitmatrix(self.k, self.w)


class ErasureCodeJerasureBlaumRoth(ErasureCodeJerasureLiberation):
    technique = "blaum_roth"
    DEFAULT_W = "6"

    def prepare(self) -> None:
        self.bitmatrix = blaum_roth_coding_bitmatrix(self.k, self.w)


TECHNIQUES = {
    "reed_sol_van": ErasureCodeJerasureReedSolomonVandermonde,
    "reed_sol_r6_op": ErasureCodeJerasureReedSolomonRAID6,
    "cauchy_orig": ErasureCodeJerasureCauchyOrig,
    "cauchy_good": ErasureCodeJerasureCauchyGood,
    "liberation": ErasureCodeJerasureLiberation,
    "blaum_roth": ErasureCodeJerasureBlaumRoth,
}


def _factory(profile, device=None):
    # host codec: runs on the CPU whatever the caller's device
    technique = profile.get("technique", "reed_sol_van")
    cls = TECHNIQUES.get(technique)
    if cls is None:
        raise ValueError(
            f"jerasure: technique {technique} not supported "
            f"(have {sorted(TECHNIQUES)})")
    return cls()


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
