"""Flat linear codec at sub-chunk granularity: the shared spine of the
recovery-bandwidth-optimal plugins (lrc, pmsr).

Both codes are systematic GF(2^8) linear codes whose structure lives in ONE
generator matrix at sub-chunk granularity: each of the n = k + m chunks is
``alpha`` sub-chunks, and the generator maps the k*alpha data sub-chunks to
all n*alpha stored sub-chunks (identity on the data rows).  LRC is the
alpha=1 case whose parity rows are the layered local/global combinations;
product-matrix MSR is the alpha=k-1 case.

  * ONE repair-matrix builder for every pattern: the lost chunks' rows
    re-expressed over the rows read (``gf.gf_solve_rows``), so a local-group
    repair and a global decode are the same call with other sources;
  * the batched data plane: ``encode_batch``/``decode_batch`` reshape
    (B, chunks, L) to (B, sub-chunks, L/alpha) and run through
    ``ops.gf2kernels.gf_matmul_batch_device``, where the XOR-schedule cost
    model picks the scheduled kernel (K3) or the dense ones (K1/K2).  The
    local parities and repair matrices are the sparse matrices greedy CSE
    minimises best, so their schedules are warmed when they are built.

The batched entry points run on the codec's ``device`` (CUDA unless the
caller passes ``device="cpu"``) for a numpy batch; a tensor stays on its own
device.  The per-op ``encode``/``decode`` run on the host, as in ``ceph_tpu``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..gf import gf_matmul, gf_solve_rows
from ..ops.gf2kernels import gf_matmul_batch_device
from ..ops.xor_schedule import warm_gf8_schedule
from .base import ErasureCode, SIMD_ALIGN


class LinearSubchunkCodec(ErasureCode):
    """Systematic (n*alpha, k*alpha) GF(2^8) code over sub-chunk rows.

    Subclasses set ``self.k``/``self.m``/``self.alpha`` and build
    ``self.generator`` (identity on the first k*alpha rows, ordered
    position-major: chunk p's sub-chunks are rows p*alpha..(p+1)*alpha)
    in their ``init``, then call ``finish_setup``.  Positions are shard
    ids; codes with a chunk remapping (LRC ``mapping`` profiles) order
    generator columns by LOGICAL data chunk and rows by position.
    """

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.k = 0
        self.m = 0
        self.alpha = 1
        self.generator: np.ndarray | None = None
        self._repair_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()

    # -- geometry -----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.alpha

    def get_alignment(self) -> int:
        # chunks must split into alpha equal sub-chunks; keep the SIMD
        # alignment when alpha already divides it
        if SIMD_ALIGN % self.alpha == 0:
            return SIMD_ALIGN
        return SIMD_ALIGN * self.alpha

    def finish_setup(self) -> None:
        """Validate the generator and warm the encode schedule."""
        ka = self.k * self.alpha
        na = (self.k + self.m) * self.alpha
        g = np.ascontiguousarray(self.generator, np.uint8)
        assert g.shape == (na, ka), (g.shape, na, ka)
        self.generator = g
        self.encode_matrix = g
        if not np.array_equal(g[self._data_rows()],
                              np.eye(ka, dtype=np.uint8)):
            raise ValueError("generator is not systematic")
        warm_gf8_schedule(self.parity_matrix)

    def _data_rows(self) -> list[int]:
        """Generator row indices of the data sub-chunks, in logical
        chunk order (mapped codes place data chunk i at position
        chunk_index(i))."""
        rows = []
        for i in range(self.k):
            p = self.chunk_index(i)
            rows.extend(range(p * self.alpha, (p + 1) * self.alpha))
        return rows

    @property
    def coding_positions(self) -> list[int]:
        """Positions hosting coding chunks, ascending (the order the
        batched encode emits parity rows in)."""
        dpos = {self.chunk_index(i) for i in range(self.k)}
        return [p for p in range(self.k + self.m) if p not in dpos]

    @property
    def parity_matrix(self) -> np.ndarray:
        """(m*alpha, k*alpha) rows of the coding positions."""
        return self.position_rows(self.coding_positions)

    def position_rows(self, positions) -> np.ndarray:
        rows = []
        for p in positions:
            rows.extend(range(p * self.alpha, (p + 1) * self.alpha))
        return np.ascontiguousarray(self.generator[rows])

    # -- sub-chunk reshapes --------------------------------------------------
    def _subrows(self, chunks: np.ndarray) -> np.ndarray:
        """(c, L) chunk rows -> (c*alpha, L/alpha) sub-chunk rows."""
        c, lane = chunks.shape
        assert lane % self.alpha == 0, (lane, self.alpha)
        return chunks.reshape(c * self.alpha, lane // self.alpha)

    def _unsubrows(self, sub: np.ndarray, c: int) -> np.ndarray:
        return sub.reshape(c, -1)

    # -- host encode/decode --------------------------------------------------
    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[self.chunk_index(i)]
                         for i in range(self.k)])
        parity = gf_matmul(self.parity_matrix, self._subrows(data))
        out = self._unsubrows(parity, self.m)
        for r, p in enumerate(self.coding_positions):
            chunks[p][:] = out[r]

    def repair_matrix(self, src: tuple[int, ...],
                      lost: tuple[int, ...]) -> np.ndarray:
        """The (len(lost)*alpha, len(src)*alpha) GF(2^8) matrix writing
        the lost chunks' sub-rows over the source chunks' sub-rows.
        Cached per (sources, lost) pattern with its XOR schedule warmed
        at build time, so repeated repairs never compile on the read
        path.  Raises IOError when the pattern is not recoverable from
        these sources."""
        key = (src, lost)
        entry = self._repair_cache.get(key)
        if entry is not None:
            self._repair_cache.move_to_end(key)
            return entry
        try:
            matrix = gf_solve_rows(self.position_rows(src),
                                   self.position_rows(lost))
        except ValueError as e:
            raise IOError(
                f"cannot repair chunks {list(lost)} from "
                f"{list(src)}: {e}") from e
        warm_gf8_schedule(matrix)
        self._cache_repair(key, matrix)
        return matrix

    def _cache_repair(self, key: tuple, matrix: np.ndarray) -> None:
        self._repair_cache[key] = matrix
        while len(self._repair_cache) > 128:
            self._repair_cache.popitem(last=False)

    def decode_chunks(self, want_to_read: set[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        available = set(chunks)
        lost = tuple(sorted(set(want_to_read) - available))
        if not lost:
            return
        src = self._decode_sources(lost, available)
        srcs = np.stack([np.asarray(chunks[p], dtype=np.uint8)
                         for p in src])
        matrix = self.repair_matrix(src, lost)
        rec = self._unsubrows(
            gf_matmul(matrix, self._subrows(srcs)), len(lost))
        for i, p in enumerate(lost):
            decoded[p][:] = rec[i]

    def _decode_sources(self, lost: tuple[int, ...],
                        available: set[int]) -> tuple[int, ...]:
        """The chunks a decode of ``lost`` reads, ascending.  The MDS
        default reads the first k survivors; layered subclasses
        override with their locality plan."""
        return tuple(sorted(available)[:self.k])

    # -- batched entry points -------------------------------------------------
    def _batch_matmul(self, matrix: np.ndarray, arr, out_chunks: int,
                      out_np: bool):
        b, c, lane = arr.shape
        sub = arr.reshape(b, c * self.alpha, lane // self.alpha)
        device = None if isinstance(arr, torch.Tensor) else self.device
        out = gf_matmul_batch_device(matrix, sub, out_np=out_np,
                                     device=device)
        return out.reshape(b, out_chunks, lane)

    def encode_batch(self, data, out_np: bool = False):
        """(B, k, L) data chunks (logical order) -> (B, m, L) coding
        chunks in ``coding_positions`` order, one launch."""
        return self._batch_matmul(self.parity_matrix, data, self.m,
                                  out_np)

    @staticmethod
    def pack_decode_extra(src, lost) -> tuple[int, ...]:
        """The (sources, lost) pattern as one int tuple: (n_src, *src,
        *lost)."""
        src = tuple(int(s) for s in src)
        lost = tuple(int(e) for e in lost)
        return (len(src),) + src + lost

    @staticmethod
    def unpack_decode_extra(extra) -> tuple[tuple, tuple]:
        extra = tuple(int(e) for e in extra)
        n_src = extra[0]
        return extra[1:1 + n_src], extra[1 + n_src:]

    def decode_signature(self, extra) -> str:
        """Grouping key: same (sources, lost) pattern = same repair
        matrix = shareable launch."""
        src, lost = self.unpack_decode_extra(extra)
        return "".join(f"+{s}" for s in src) + "".join(
            f"-{e}" for e in lost)

    def decode_plan(self, want: set[int],
                    have: set[int]) -> tuple[tuple, tuple] | None:
        """(source positions, lost positions) for the batched decode,
        or None when per-stripe host decode must serve.  The sources
        follow the codec's own selection (locality for LRC), restricted
        to what the caller actually holds."""
        lost = tuple(sorted(set(want) - set(have)))
        if not lost:
            return None
        try:
            src = self._decode_sources(lost, set(have))
        except (IOError, OSError, ValueError):
            return None
        if not set(src) <= set(have):
            return None
        return src, lost

    def decode_batch(self, erasures, survivors, out_np: bool = False):
        """Batched repair: ``erasures`` is the packed (n_src, *src,
        *lost) extra; ``survivors`` is (B, len(src), L) in src order.
        Returns (B, len(lost), L)."""
        src, lost = self.unpack_decode_extra(erasures)
        matrix = self.repair_matrix(src, lost)
        return self._batch_matmul(matrix, survivors, len(lost), out_np)

    # -- repair planning ------------------------------------------------------
    def minimum_to_repair(self, lost: int, available: set[int]
                          ) -> dict[int, list[tuple[int, int]]] | None:
        """Sub-chunk read/compute spec to rebuild one lost chunk, or
        None when plain minimum_to_decode should serve.  Regenerating
        subclasses return the helper set with beta-sized fragment
        counts; layered codes, whose savings come from READING fewer
        chunks, defer to minimum_to_decode."""
        return None
