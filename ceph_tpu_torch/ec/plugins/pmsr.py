"""Product-matrix MSR (minimum-storage regenerating) plugin.

The Rashmi-Shah-Kumar product-matrix construction ("Optimal
Exact-Regenerating Codes... via a Product-Matrix Construction"; the
execution blueprint is "Fast Product-Matrix Regenerating Codes",
PAPERS.md) at the MSR point, rendered over GF(2^8):

  * parameters [n = k + m, k, d = 2(k-1)] with sub-packetization
    alpha = k - 1 and per-helper repair bandwidth beta = 1 sub-chunk;
  * the message is two symmetric (alpha x alpha) matrices S1, S2
    (k*alpha free symbols = exactly the data), node i stores
    psi_i @ [S1; S2] where psi_i = [phi_i, lambda_i * phi_i] is row i
    of a Vandermonde encoding matrix -- any d rows of Psi and any
    alpha rows of Phi are nonsingular and the lambda_i are distinct,
    which is all the construction needs;
  * REPAIR of one lost chunk f: each of d helpers ships ONE computed
    sub-chunk (its alpha stored sub-chunks combined by phi_f -- a
    beta-sized fragment, NOT a stored range), and the collector solves
    the d x d system Psi_H u = fragments to rebuild the chunk.  Total
    repair traffic: d/alpha = 2 chunks' worth of bytes instead of the
    k full chunks RS repair reads.

A copy of ``ceph_tpu``'s pmsr plugin.  The whole construction is
linearized into the flat systematic generator of ec/linear_codec.py
(solve the first k nodes' stored symbols for the message -- the
standard systematic remap), so encode/decode run through the
scheduled (K3) or dense (K1/K2) kernels on the codec's device, MDS
decode from any k chunks is the generic repair-matrix build, and only
the fragment algebra (phi_f combination, Psi_H^{-1} aggregation) is
MSR-specific; it runs on the host.  Fragment and aggregate matrices are
LRU-cached with their XOR schedules warmed at build time.

Profile: ``plugin=pmsr k=K m=M [d=D]`` with k >= 3, m >= k-1 and
d = 2(k-1) (the product-matrix admissibility conditions; defaults to
d = 2(k-1), which equals k+m-1 -- every surviving node helps -- at the
canonical m = k-1 shape).
"""

from __future__ import annotations

import numpy as np

from ...gf.gf8 import (GF_EXP, GF_MUL_TABLE, gf_invert_matrix, gf_matmul,
                       gf_mul, gf_pow)
from ...ops.xor_schedule import warm_gf8_schedule
from ..linear_codec import LinearSubchunkCodec
from ..registry import ErasureCodePlugin


def _pm_vandermonde(n: int, d: int) -> np.ndarray:
    """Psi: (n, d) Vandermonde rows psi_i = [1, x_i, ..., x_i^(d-1)]
    with x_i = g^i (g a field generator), so any d rows are
    nonsingular, any alpha = d/2 leading columns' rows are nonsingular
    (Phi), and lambda_i = x_i^alpha are pairwise distinct for
    n <= 255 / gcd(alpha, 255) (asserted by the caller)."""
    psi = np.zeros((n, d), dtype=np.uint8)
    for i in range(n):
        x = int(GF_EXP[i % 255]) if i else 1
        p = 1
        for j in range(d):
            psi[i, j] = p
            p = gf_mul(p, x)
    return psi


class ErasureCodePmsr(LinearSubchunkCodec):
    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.d = 0
        self.phi: np.ndarray | None = None        # (n, alpha)
        self.lambdas: np.ndarray | None = None    # (n,)
        self.psi: np.ndarray | None = None        # (n, d)

    # -- profile ------------------------------------------------------------
    def _parse(self, profile) -> None:
        k = self.to_int("k", profile, "0")
        m = self.to_int("m", profile, "0")
        if k < 3:
            raise ValueError(
                f"pmsr: k={k} must be >= 3: the product-matrix MSR "
                f"sub-packetization is alpha=k-1 and alpha >= 2 is "
                f"what makes beta-sized repair fragments smaller than "
                f"chunks (EINVAL)")
        if m < k - 1:
            raise ValueError(
                f"pmsr: m={m} must be >= k-1={k - 1}: repair needs "
                f"d=2(k-1) helpers among the n-1={k + m - 1} "
                f"survivors (EINVAL)")
        d_default = 2 * (k - 1)
        d = self.to_int("d", profile, str(d_default))
        if d != d_default:
            raise ValueError(
                f"pmsr: d={d} is not admissible: the product-matrix "
                f"MSR construction exists exactly at d=2(k-1)"
                f"={d_default} (EINVAL)")
        self.k, self.m, self.d = k, m, d
        self.alpha = k - 1
        n = k + m
        # lambda_i = x_i^alpha distinct needs n below the power-map
        # period
        import math
        period = 255 // math.gcd(self.alpha, 255)
        if n > period:
            raise ValueError(
                f"pmsr: k+m={n} exceeds {period}, the largest width "
                f"with distinct repair multipliers over GF(2^8) for "
                f"alpha={self.alpha} (EINVAL)")

    def _build(self) -> None:
        k, m, d, a = self.k, self.m, self.d, self.alpha
        n = k + m
        psi = _pm_vandermonde(n, d)
        self.psi = psi
        self.phi = np.ascontiguousarray(psi[:, :a])
        self.lambdas = np.array(
            [gf_pow(int(GF_EXP[i % 255]) if i else 1, a)
             for i in range(n)], dtype=np.uint8)
        assert len(set(self.lambdas.tolist())) == n, \
            "repair multipliers not distinct"
        # the message -> stored-symbol map G: theta (the k*alpha free
        # entries of the symmetric S1, S2) -> the n*alpha stored
        # sub-symbols; stored_{i,a} = sum_b phi_i[b]*S1[b,a]
        #                           + lambda_i * sum_b phi_i[b]*S2[b,a]
        half = a * (a + 1) // 2
        nfree = 2 * half
        assert nfree == k * a, (nfree, k * a)
        pidx = {}
        t = 0
        for p in range(a):
            for q in range(p, a):
                pidx[(p, q)] = t
                t += 1
        g = np.zeros((n * a, nfree), dtype=np.uint8)
        for i in range(n):
            lam = int(self.lambdas[i])
            for col in range(a):
                row = g[i * a + col]
                for b in range(a):
                    key = pidx[(min(b, col), max(b, col))]
                    c = int(self.phi[i, b])
                    row[key] ^= c                       # S1 term
                    row[half + key] ^= gf_mul(lam, c)   # S2 term
        # systematic remap: choose theta so the first k nodes store the
        # raw data (invert the data-node block; nonsingular by the
        # product-matrix data-reconstruction property)
        inv = gf_invert_matrix(g[:k * a])
        gen = np.zeros((n * a, k * a), dtype=np.uint8)
        for r in range(n * a):
            row = np.zeros(k * a, dtype=np.uint8)
            for j in range(nfree):
                c = int(g[r, j])
                if c:
                    row ^= GF_MUL_TABLE[c][inv[j]]
            gen[r] = row
        self.generator = gen

    def init(self, profile) -> None:
        self._parse(profile)
        self.parse(profile)
        self._build()
        self.finish_setup()
        super().init(profile)

    # -- fragment repair algebra ---------------------------------------------
    def fragment_row(self, lost: int) -> np.ndarray:
        """(1, alpha) coefficients every helper applies to its own
        sub-chunks to produce its beta=1 repair fragment: phi_f."""
        return np.ascontiguousarray(self.phi[lost][None, :])

    def aggregate_matrix(self, lost: int,
                         helpers: tuple[int, ...]) -> np.ndarray:
        """(alpha, d) matrix mapping the d helper fragments (in helper
        order) to the lost chunk's alpha sub-chunks:
        [I | lambda_f I] @ Psi_H^{-1}.  Cached (the shared repair LRU)
        with its XOR schedule warmed."""
        key = ("agg", lost, helpers)
        entry = self._repair_cache.get(key)
        if entry is not None:
            self._repair_cache.move_to_end(key)
            return entry
        if len(helpers) != self.d:
            raise IOError(
                f"pmsr: repair of chunk {lost} needs exactly d="
                f"{self.d} helpers, got {len(helpers)}")
        inv = gf_invert_matrix(self.psi[list(helpers)])
        a = self.alpha
        lam = int(self.lambdas[lost])
        agg = inv[:a] ^ GF_MUL_TABLE[lam][inv[a:]]
        agg = np.ascontiguousarray(agg)
        warm_gf8_schedule(agg)
        self._cache_repair(key, agg)
        return agg

    def fragment_for(self, lost: int, chunk: np.ndarray) -> np.ndarray:
        """A helper's beta-sized fragment for repairing ``lost``: its
        own chunk's alpha sub-chunks combined by phi_f, stripe by
        stripe.  ``chunk`` is the helper's whole shard buffer (one
        chunk of chunk_size bytes per stripe); returns
        len(chunk)/alpha bytes, per-stripe fragments concatenated."""
        a = self.alpha
        buf = np.ascontiguousarray(chunk, np.uint8)
        cs = self._fragment_chunk_size(buf.size)
        sc = cs // a
        stacked = buf.reshape(-1, a, sc)                  # (nc, a, sc)
        flat = stacked.transpose(1, 0, 2).reshape(a, -1)  # (a, nc*sc)
        frag = gf_matmul(self.fragment_row(lost), flat)   # (1, nc*sc)
        return np.ascontiguousarray(frag.reshape(-1))

    def _fragment_chunk_size(self, shard_len: int) -> int:
        """Per-stripe chunk size within a shard buffer: the sub-chunk
        split is per CHUNK, so multi-stripe shards must reshape at the
        real stripe granularity.  The backend snapshots it via
        ``set_fragment_chunk_size`` at pool attach; a buffer it does
        not divide (bare codec tests) is treated as a single chunk."""
        cs = getattr(self, "_frag_cs", 0)
        if cs and shard_len % cs == 0:
            return cs
        assert shard_len % self.alpha == 0, (shard_len, self.alpha)
        return shard_len

    def set_fragment_chunk_size(self, chunk_size: int) -> None:
        assert chunk_size % self.alpha == 0, (chunk_size, self.alpha)
        self._frag_cs = int(chunk_size)

    def aggregate_fragments(self, lost: int,
                            frags: dict[int, np.ndarray]) -> np.ndarray:
        """Rebuild the lost chunk from beta-sized helper fragments
        keyed by helper position.  Byte-identical to the full decode
        of the same chunk (pinned by tests): both equal the stored
        generator rows applied to the data."""
        helpers = tuple(sorted(frags))
        agg = self.aggregate_matrix(lost, helpers)
        a = self.alpha
        flen = {len(np.asarray(f).reshape(-1)) for f in frags.values()}
        assert len(flen) == 1, flen
        flen = flen.pop()
        sc = self._fragment_chunk_size(flen * a) // a
        stacked = np.stack(
            [np.ascontiguousarray(np.asarray(frags[h], np.uint8)
                                  .reshape(-1)).reshape(-1, sc)
             for h in helpers])                    # (d, nc, sc)
        flat = stacked.reshape(len(helpers), -1)   # (d, nc*sc)
        rec = gf_matmul(agg, flat)                 # (a, nc*sc)
        out = rec.reshape(a, -1, sc).transpose(1, 0, 2)
        return np.ascontiguousarray(out.reshape(-1))

    # -- repair planning ------------------------------------------------------
    def minimum_to_repair(self, lost: int, available: set[int]
                          ) -> dict[int, list[tuple[int, int]]] | None:
        """The MSR helper set + fragment spec for a single lost chunk:
        d helpers each contributing one beta-sized computed sub-chunk
        ([(0, 1)] in sub-chunk units).  None when fewer than d
        survivors are reachable -- the caller falls back to the MDS
        k-chunk decode."""
        cands = sorted(set(available) - {lost})
        if len(cands) < self.d:
            return None
        helpers = cands[:self.d]
        return {h: [(0, 1)] for h in helpers}


def _factory(profile, device=None):
    return ErasureCodePmsr(device)


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
