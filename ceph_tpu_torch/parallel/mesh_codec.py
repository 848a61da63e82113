"""MeshCodec: the OSD data plane's launch engine, on one CUDA card.

Port of ``ceph_tpu/parallel/mesh_codec.py``, with the interface the
``CodecBatcher`` calls: ``supports``, ``pad_batch`` and one launch per
``encode`` / ``decode`` / ``rmw`` of a whole coalesced (B, k, L) stripe
batch, byte-identical to the per-stripe host codec.  The reference
partitions the batch over a 1-D jax mesh of every visible device with
``shard_map``; on one H100 the plane has one device:

  * every launch goes through ``ops.gf2kernels.gf_matmul_batch_device``,
    which asks the XOR-schedule cost model first (K3) and then routes
    dense (K1/K2), so the reference's scheduled twins (``_apply_sched``,
    ``_rmw_sched``) collapse into that one call;
  * the fused CRC32C rides the same device round trip, in both dialects:
    K4 over the batch and over the fresh parity while both are on the card
    (``ops.torch_backend.gf_matmul_chunks_crc``);
  * donation becomes buffer reuse: with ``donate`` (the default) a batch
    that is already a tensor on the card is launched as it is, and RMW
    XORs M.delta into the old-parity tensor IN PLACE
    (``torch.Tensor.bitwise_xor_``, outside any kernel, as the reference
    leaves the XOR to XLA), so a tensor passed in is the launch's from
    then on; ``donate=False`` copies it first.  A numpy batch is always
    copied, so the caller's host arrays are never written;
  * a failing launch raises: the reference's ``_sched_health`` /
    ``STATS.note_fallback`` guard is not carried.

``n_devices > 1`` raises ``NotImplementedError``: a ``MeshCodec`` spanning
several cards in one process is ROADMAP queue 1, item 5.  Ranks of a
``torch.distributed`` process group, one a process, run the sharded codec
(``parallel/sharded_ec.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops.crc32c_batch import to_uint32
from ..ops.gf2kernels import bucket_batch
from ..ops.torch_backend import gf_matmul_chunks, gf_matmul_chunks_crc


@functools.lru_cache(maxsize=256)
def _decode_matrix_cached(mat_bytes: bytes, rows: int, k_total: int,
                          k: int, erasures: tuple) -> np.ndarray:
    """build_decode_matrix product for codecs without their own
    DecodeTableCache; same construction as the cuda plugin's, so the
    mesh decode is byte-identical to decode_batch."""
    from ..gf import build_decode_matrix
    enc = np.frombuffer(mat_bytes, np.uint8).reshape(rows, k_total)
    matrix, _ = build_decode_matrix(enc, k, list(erasures))
    return matrix


def _host(out: torch.Tensor) -> np.ndarray:
    """The single post-launch materialization."""
    # lint: disable=device-path-host-sync -- the one post-launch hop
    return out.cpu().numpy()


class MeshCodec:
    """One card presented as one giant erasure codec.

    ``encode``/``decode``/``rmw`` each run ONE launch of the GF(2^8)
    product (K1 one per ``popc_stripes`` range and ``popc_plan`` tile) for
    a whole (B, k, L) stripe batch on ``device`` (CUDA unless the caller
    passes ``device="cpu"``, which runs the plain versions).
    ``pad_batch`` gives the bucketed size the CodecBatcher pads to.
    """

    def __init__(self, n_devices: int = 0, donate: bool = True,
                 perf=None, device=None) -> None:
        if int(n_devices) > 1:
            raise NotImplementedError(
                f"MeshCodec spans one card; n_devices={n_devices} needs a "
                f"multi-card MeshCodec (ROADMAP queue 1, item 5)")
        self.device = resolve_device(device)
        self.n_devices = 1
        self.donate = bool(donate)
        self.perf = perf
        if perf is not None:
            perf.set_gauge("mesh_devices", self.n_devices)

    # -- capability gate ----------------------------------------------------
    @staticmethod
    def supports(codec) -> bool:
        """The mesh speaks two coefficient-matrix dialects: the cuda codec
        family (the ``encode_batch_crc`` marker: the encode matrix drives
        the launch directly and the decode matrix is the same
        build_decode_matrix product decode_batch uses) and the flat
        sub-chunk family (the ``mesh_flat_ok`` marker, ec/linear_codec.py:
        chunks reshape to alpha sub-chunk rows around the same launches,
        matrices from ``parity_matrix``/``decode_flat_matrix``).  Both
        dialects fuse the chunk CRCs into ``encode``."""
        if getattr(codec, "mesh_flat_ok", False):
            return True
        return (hasattr(codec, "encode_batch_crc")
                and getattr(codec, "encode_matrix", None) is not None
                and not codec.get_chunk_mapping())

    @staticmethod
    def _flat(codec) -> bool:
        return getattr(codec, "mesh_flat_ok", False)

    def pad_batch(self, total: int) -> int:
        """Bucketed launch batch: a power of two (bounded distinct
        shapes) that the device count (one) divides.  Zero rows are
        byte-exact padding."""
        return max(bucket_batch(total), 1)

    # -- launches ------------------------------------------------------------
    def _count(self, b: int) -> None:
        if self.perf is not None:
            self.perf.inc("mesh_launches")
            self.perf.inc("mesh_padded_stripes", b)

    def _check_codec(self, codec) -> None:
        dev = getattr(codec, "device", None)
        if dev is not None and torch.device(dev) != self.device:
            raise ValueError(f"codec runs on {dev}, this MeshCodec on "
                             f"{self.device}")

    def _put(self, arr) -> torch.Tensor:
        """The launch's device buffer: a tensor on the device as it is
        when donated (do not read it afterwards), else a copy."""
        if isinstance(arr, torch.Tensor):
            t = arr.to(device=self.device, dtype=torch.uint8).contiguous()
            return t if self.donate or t.data_ptr() != arr.data_ptr() \
                else t.clone()
        a = np.ascontiguousarray(arr, np.uint8)
        if self.device.type == "cpu" or not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    @classmethod
    def _alpha(cls, codec) -> int:
        """Sub-chunk rows a chunk: the flat dialect's alpha, else 1."""
        return codec.alpha if cls._flat(codec) else 1

    @classmethod
    def _parity_matrix(cls, codec) -> np.ndarray:
        return (codec.parity_matrix if cls._flat(codec)
                else codec.encode_matrix[codec.k:])

    def _apply(self, matrix: np.ndarray, batch, alpha: int,
               with_crc: bool = False):
        x = self._put(batch)
        self._count(x.shape[0])
        if with_crc:
            return gf_matmul_chunks_crc(matrix, x, alpha)
        return gf_matmul_chunks(matrix, x, alpha)

    def encode(self, codec, batch, with_crc: bool = False,
               out_np: bool = True):
        """(B, k, L) data chunks -> (B, m, L) parity in one launch;
        ``with_crc`` adds the (B, k+m) chunk CRCs computed on the card in
        the same round trip (np.uint32, or int64 registers on the device
        with ``out_np=False``).  ``out_np=False`` leaves the result on the
        device (the pipelined batcher defers the materialization)."""
        self._check_codec(codec)
        mat = self._parity_matrix(codec)
        if not with_crc:
            out = self._apply(mat, batch, self._alpha(codec))
            return _host(out) if out_np else out
        out, crcs = self._apply(mat, batch, self._alpha(codec), True)
        if not out_np:
            return out, crcs
        return _host(out), to_uint32(crcs)

    def decode(self, codec, erasures, batch, out_np: bool = True):
        """(B, k, L) survivors (decode-index order, the decode_batch
        contract) -> (B, len(erasures), L) recovered chunks."""
        self._check_codec(codec)
        erasures = tuple(int(e) for e in erasures)
        if self._flat(codec):
            # the packed (sources, lost) extra selects the SAME cached
            # repair matrix decode_batch uses
            matrix = codec.decode_flat_matrix(list(erasures))
        elif hasattr(codec, "decode_matrix_for"):
            # the plugin's DecodeTableCache: the SAME matrix decode_batch
            # would use
            matrix = codec.decode_matrix_for(list(erasures))
        else:
            enc = np.ascontiguousarray(codec.encode_matrix, np.uint8)
            matrix = _decode_matrix_cached(enc.tobytes(), *enc.shape,
                                           codec.k, erasures)
        out = self._apply(matrix, batch, self._alpha(codec))
        return _host(out) if out_np else out

    def rmw(self, codec, old_parity, delta, out_np: bool = True):
        """Partial-stripe RMW: (B, m, L) old parity + (B, k, L) delta
        (zeros outside the written range) -> (B, m, L) new parity, by GF
        linearity.  One launch; the result is the old-parity device
        tensor, updated in place."""
        self._check_codec(codec)
        mat = self._parity_matrix(codec)
        old = self._put(old_parity)
        # GF linearity holds per sub-chunk row identically (flat dialect)
        old.bitwise_xor_(self._apply(mat, delta, self._alpha(codec)))
        if self.perf is not None:
            self.perf.inc("mesh_rmw_launches")
        return _host(old) if out_np else old
