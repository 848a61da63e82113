"""ISA-semantics Reed-Solomon plugin (host/numpy execution).

Vandermonde (technique=reed_sol_van, the default) or Cauchy
(technique=cauchy) generator matrices over GF(2^8)/0x11d, chunk size
ceil(stripe/k) rounded up to 32 bytes, decode over the first k surviving
shards with an LRU decode-matrix cache.

The ``cuda`` plugin computes the same bytes on the card; this plugin is the
host-side oracle and its base class.
"""

from __future__ import annotations

from ..rs_codec import RSMatrixCodec
from ..registry import ErasureCodePlugin
from ...gf import gen_rs_matrix, gen_cauchy1_matrix

EC_ISA_ADDRESS_ALIGNMENT = 32

K_VANDERMONDE = "reed_sol_van"
K_CAUCHY = "cauchy"

DEFAULT_K = "7"
DEFAULT_M = "3"


class ErasureCodeIsa(RSMatrixCodec):
    def __init__(self, technique: str = K_VANDERMONDE, backend=None) -> None:
        super().__init__(backend=backend)
        self.technique = technique

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def parse_km(self, profile) -> None:
        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        if self.technique == K_VANDERMONDE:
            # verified-safe envelope of the non-systematized Vandermonde
            # construction
            if self.k > 32:
                raise ValueError(f"Vandermonde: k={self.k} must be <= 32")
            if self.m > 4:
                raise ValueError(
                    f"Vandermonde: m={self.m} must be < 5 for an MDS codec")
            if self.m == 4 and self.k > 21:
                raise ValueError(
                    f"Vandermonde: k={self.k} must be < 22 with m=4")

    def prepare(self) -> None:
        if self.technique == K_CAUCHY:
            self.encode_matrix = gen_cauchy1_matrix(self.k + self.m, self.k)
        else:
            self.encode_matrix = gen_rs_matrix(self.k + self.m, self.k)

    def init(self, profile) -> None:
        self.parse(profile)
        technique = profile.get("technique", self.technique)
        if technique not in (K_VANDERMONDE, K_CAUCHY):
            raise ValueError(f"isa: unknown technique {technique}")
        self.technique = technique
        self.parse_km(profile)
        self.prepare()
        super().init(profile)


def _factory(profile, device=None):
    # host codec: runs on the CPU whatever the caller's device
    return ErasureCodeIsa(profile.get("technique", K_VANDERMONDE))


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
