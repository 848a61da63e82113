"""GF(2) bit-matrix codec: the jerasure bitmatrix-technique data path.

jerasure's cauchy/liberation/blaum_roth techniques encode by XORing
w-bit packet rows selected by a (m*w, k*w) GF(2) matrix
(jerasure_bitmatrix_encode): each chunk is a sequence of regions of
w * packetsize bytes; packet row c of region g of chunk j is plane
(j*w + c); coding plane r = XOR of the data planes with a 1 in
bitmatrix row r.  Decode inverts the (k*w)-square submatrix of
surviving generator rows over GF(2).

The XOR formulation is the GF(2) product the card's kernels compute
(ops/gf2kernels.py, ops/xor_schedule.py) at another plane granularity
(w-bit packets instead of bit planes); this codec runs it on the host,
through the XOR schedule's host executor (``apply_host``).

Port of ``ceph_tpu/ec/bitmatrix_codec.py``: host code, as in the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np

from ..gf.gf2w import gf2_invert
from ..ops.xor_schedule import scheduled_xor_matmul, warm_schedule
from .base import ErasureCode


class BitMatrixCodec(ErasureCode):
    """Systematic (k+m, k) code defined by a (m*w, k*w) GF(2) matrix.

    Subclasses set self.k/self.m/self.w/self.packetsize and build
    self.bitmatrix in prepare()."""

    def __init__(self) -> None:
        super().__init__()
        self.k = 0
        self.m = 0
        self.w = 8
        self.packetsize = 8
        self.bitmatrix: np.ndarray | None = None
        self._inv_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()

    # -- geometry -----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        # chunk must hold whole regions of w*packetsize bytes
        # (ErasureCodeJerasure{Cauchy,Liberation}::get_alignment)
        return self.k * self.w * self.packetsize

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        tail = stripe_width % alignment
        padded = stripe_width + (alignment - tail if tail else 0)
        return padded // self.k

    # -- plane layout -------------------------------------------------------
    def _planes(self, chunks: np.ndarray) -> np.ndarray:
        """(n, csize) chunk rows -> (n*w, csize//w) packet planes."""
        n, csize = chunks.shape
        ps = self.packetsize
        regions = csize // (self.w * ps)
        # (n, regions, w, ps) -> (n, w, regions, ps) -> (n*w, regions*ps)
        return (chunks.reshape(n, regions, self.w, ps)
                .transpose(0, 2, 1, 3)
                .reshape(n * self.w, regions * ps))

    def _unplanes(self, planes: np.ndarray, n: int,
                  csize: int) -> np.ndarray:
        ps = self.packetsize
        regions = csize // (self.w * ps)
        return (planes.reshape(n, self.w, regions, ps)
                .transpose(0, 2, 1, 3)
                .reshape(n, csize))

    # -- encode/decode ------------------------------------------------------
    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([chunks[self.chunk_index(i)] for i in range(k)])
        csize = data.shape[1]
        if csize % (self.w * self.packetsize):
            raise ValueError(
                f"chunk size {csize} not a multiple of w*packetsize="
                f"{self.w * self.packetsize}")
        planes = self._planes(data)
        # the CSE-minimized XOR schedule (ops/xor_schedule.py): the
        # encode matrix is hot for the codec's lifetime, so compile on
        # first use; byte-identical to the naive row-by-row XOR
        coding = scheduled_xor_matmul(self.bitmatrix, planes)
        out = self._unplanes(coding, m, csize)
        for r in range(m):
            chunks[self.chunk_index(k + r)][:] = out[r]

    def _generator_rows(self, chunk: int) -> np.ndarray:
        """The w generator rows (over the k*w data planes) of ``chunk``."""
        kw = self.k * self.w
        if chunk < self.k:
            rows = np.zeros((self.w, kw), dtype=np.uint8)
            for r in range(self.w):
                rows[r, chunk * self.w + r] = 1
            return rows
        return self.bitmatrix[(chunk - self.k) * self.w:
                              (chunk - self.k + 1) * self.w]

    def _repair_matrix(self, sel: tuple[int, ...],
                       erasures: tuple[int, ...]) -> np.ndarray:
        """ONE (len(erasures)*w, k*w) GF(2) matrix mapping the
        surviving planes directly to every missing chunk's planes:
        data erasure e contributes rows inv[e*w:(e+1)*w], coding
        erasure e contributes bitmatrix_rows(e) @ inv (mod 2) -- so
        repair is a single launch instead of one per lost chunk.
        Cached per (survivor set, erasure pattern) and its XOR
        schedule warmed at build time, so repeated repairs ride the
        scheduled kernel without paying a compile on the read path."""
        key = (",".join(map(str, sel)), ",".join(map(str, erasures)))
        entry = self._inv_cache.get(key)
        if entry is not None:
            self._inv_cache.move_to_end(key)   # LRU, not FIFO
            return entry
        w = self.w
        s = np.concatenate([self._generator_rows(c) for c in sel])
        inv = gf2_invert(s)               # raises if not decodable
        rows = []
        for e in erasures:
            if e < self.k:
                rows.append(inv[e * w:(e + 1) * w])
            else:
                gen = self.bitmatrix[(e - self.k) * w:
                                     (e - self.k + 1) * w]
                rows.append((gen.astype(np.uint32)
                             @ inv.astype(np.uint32)) & 1)
        repair = np.ascontiguousarray(
            np.concatenate(rows).astype(np.uint8))
        warm_schedule(repair)
        self._inv_cache[key] = repair
        while len(self._inv_cache) > 128:
            self._inv_cache.popitem(last=False)
        return repair

    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        erasures = [i for i in range(k + m) if i not in chunks]
        if not erasures:
            return
        if len(erasures) > m:
            raise IOError(f"{len(erasures)} erasures exceed m={m}")
        available = sorted(set(range(k + m)) - set(erasures))
        sel = available[:k]
        repair = self._repair_matrix(tuple(sel), tuple(erasures))
        csize = len(next(iter(decoded.values())))
        src = np.stack([decoded[c] for c in sel])
        # every missing chunk (data AND coding) from one launch; the
        # schedule was warmed when the repair matrix was built, so
        # the read path never compiles (allow_compile=False)
        planes = scheduled_xor_matmul(repair, self._planes(src),
                                      allow_compile=False)
        out = self._unplanes(planes, len(erasures), csize)
        for i, e in enumerate(erasures):
            decoded[e][:] = out[i]
