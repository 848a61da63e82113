"""Per-OSD cross-PG EC codec micro-batching.

Port of ``ceph_tpu/osd/codec_batcher.py``: the OSD's entry point to the
erasure-code data plane.  Every ECBackend on an OSD (across all its PGs)
submits encode, decode and RMW work here; the batcher coalesces stripe
sets from concurrently in-flight ops into single launches and fans the
results back to per-op futures byte-identically.

Mechanics (as in the reference):

  * submissions are grouped by codec *profile signature* (the encode
    matrix bytes + (k, m), plus the erasure pattern for decodes), so
    stripes from different PGs with the same profile share a launch;
  * ragged tails are zero-padded to a common (B, k, L) and sliced back
    (the GF matmul is column-independent, so this is byte-exact), the
    batch axis rounded up to a power-of-two bucket; fused chunk CRCs
    computed at the padded lane width are un-padded with
    ``crc32c_strip_zeros`` instead of re-hashing;
  * a group flushes when it reaches ``max_batch`` stripes, when the event
    loop completes a pass with no new submissions, or on a timer;
  * coalesced batches of mesh-capable codecs launch through
    ``parallel/mesh_codec.MeshCodec`` on the batcher's ``device`` (CUDA
    unless ``device="cpu"``): one launch per batch, with the chunk CRCs
    by kernel K4 in the same device round trip;
  * the launch spine is double-buffered: ``_marshal`` (host pad and
    stack), ``_dispatch`` (device launch, no materialization) and
    ``_complete`` (the single ``.cpu().numpy()`` and the fan-out), with a
    staging queue so batch N+1's host staging overlaps launch N;
    ``pipeline=False`` runs the same three functions inline.

Where the port differs: a mesh launch that fails fails that batch's
waiters (through ``_fail``); the reference's degrade-to-the-single-device-
ladder ``try``/``except`` is not carried, so ``mesh_fallbacks`` stays 0.

Occupancy is surfaced as perf counters ("ec_batch"): batches launched, a
stripes-per-batch histogram, padding waste and flush reasons.
"""

from __future__ import annotations

import asyncio
from collections import Counter

import numpy as np
import torch

STRIPE_HIST_BUCKETS = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                       256.0, 512.0]


def codec_signature(codec, kind: str, extra: tuple) -> tuple:
    """Launch-compatibility key: submissions with the same signature
    compute with the same coefficient matrix and may share a batch.
    Decode submissions fold in the DecodeTableCache signature (the
    erasure pattern picks the decode matrix)."""
    if kind == "decode" and hasattr(codec, "decode_signature"):
        extra = (codec.decode_signature(extra),) + extra
    return (kind, codec.k, codec.m,
            codec.encode_matrix.tobytes(), extra)


class _Group:
    """One pending batch: submissions awaiting a shared launch."""

    __slots__ = ("codec", "kind", "extra", "items", "n_stripes", "task")

    def __init__(self, codec, kind: str, extra: tuple) -> None:
        self.codec = codec
        self.kind = kind                 # "encode" | "decode"
        self.extra = extra               # decode: erasure tuple
        self.items: list[tuple[np.ndarray, asyncio.Future, bool]] = []
        self.n_stripes = 0
        self.task: asyncio.Task | None = None


class _Staged:
    """One marshaled batch parked between staging and launch: the
    host work (padding, stacking, CRC wants) is DONE; only the device
    dispatch and the post-launch fan-out remain."""

    __slots__ = ("grp", "reason", "batch", "old_batch", "want_crc",
                 "lane", "total", "b", "payload", "mesh")

    def __init__(self, grp, reason, batch, old_batch, want_crc,
                 lane, total, b, payload, mesh) -> None:
        self.grp = grp
        self.reason = reason
        self.batch = batch
        self.old_batch = old_batch
        self.want_crc = want_crc
        self.lane = lane
        self.total = total
        self.b = b
        self.payload = payload
        self.mesh = mesh


class CodecBatcher:
    """Asyncio micro-batching stage for EC codec launches.

    ``await encode(codec, stripes)`` with stripes shaped (n, k, L)
    resolves to the (n, m, L) parity chunks; ``await decode(codec,
    erasures, survivors)`` with survivors shaped (n, k, L) in
    decode-index order resolves to the (n, len(erasures), L) recovered
    chunks.  Results are byte-identical to per-stripe codec.encode /
    codec.decode.
    """

    def __init__(self, *, max_batch: int = 64,
                 flush_timeout: float = 0.002,
                 eager_flush: bool = True, perf=None,
                 mesh="auto", mesh_devices: int = 0,
                 mesh_donate: bool = True,
                 pipeline: bool = True, staging_depth: int = 4,
                 pipe_perf=None, device=None) -> None:
        self.max_batch = max(1, int(max_batch))
        self.flush_timeout = float(flush_timeout)
        self.eager_flush = bool(eager_flush)
        self.perf = perf
        # double-buffered launch spine: staged batches queue here and
        # a single launcher task launches them, so the NEXT batch's host
        # marshal overlaps the current launch's device time.  Depth
        # bounds parked host memory; a flush finding the queue full
        # launches inline (a counted stall, never an unbounded queue).
        self.pipeline = bool(pipeline)
        self.staging_depth = max(1, int(staging_depth))
        self.pipe_perf = pipe_perf
        from collections import deque
        self._staged: deque[_Staged] = deque()
        self._drive_task: asyncio.Task | None = None
        # data plane (parallel/mesh_codec.py): "auto" builds a MeshCodec
        # on ``device`` LAZILY on the first mesh-eligible launch, None
        # keeps the codecs' own batch launches, or pass a MeshCodec
        # instance directly.  All knobs are SNAPSHOT
        # here -- no config object is retained and nothing is looked
        # up per batch (from_config + the test_mesh_codec assertion).
        self._mesh = mesh if mesh != "auto" else None
        self._mesh_auto = mesh == "auto"
        self._mesh_devices = int(mesh_devices)
        self._mesh_donate = bool(mesh_donate)
        # the device the MeshCodec this batcher builds runs on
        self.device = device
        self._groups: dict[tuple, _Group] = {}
        self._closed = False
        # completed launches by (kind, launch batch shape, erasures)
        self.launch_shapes: Counter = Counter()
        if perf is not None:
            perf.hist_register("stripes_per_batch", STRIPE_HIST_BUCKETS)

    @classmethod
    def from_config(cls, conf, perf=None, pipe_perf=None,
                    device=None) -> "CodecBatcher | None":
        """Construction-time snapshot of every batcher/mesh/pipeline
        knob (the hot launch loop must never call ``conf.get``).
        Returns None when EC batching is disabled."""
        if not conf.get("osd_ec_batch_enabled", True):
            return None
        return cls(
            max_batch=int(conf.get("osd_ec_batch_max", 64)),
            flush_timeout=float(conf.get("osd_ec_batch_timeout",
                                         0.002)),
            eager_flush=bool(conf.get("osd_ec_batch_eager_flush",
                                      True)),
            mesh=("auto" if conf.get("osd_ec_mesh_enabled", True)
                  else None),
            mesh_devices=int(conf.get("osd_ec_mesh_devices", 0)),
            mesh_donate=bool(conf.get("osd_ec_mesh_donate", True)),
            pipeline=bool(conf.get("osd_pipeline_enabled", True)),
            staging_depth=int(conf.get("osd_pipeline_staging_depth",
                                       4)),
            perf=perf, pipe_perf=pipe_perf, device=device)

    def _mesh_for(self, codec):
        """The data-plane launch engine for this codec, or None (then the
        codec's own single-device batch entry points serve)."""
        if self._mesh is None and not self._mesh_auto:
            return None
        from ..parallel.mesh_codec import MeshCodec
        if not MeshCodec.supports(codec):
            return None
        if self._mesh is None:
            self._mesh = MeshCodec(n_devices=self._mesh_devices,
                                   donate=self._mesh_donate,
                                   perf=self.perf, device=self.device)
        return self._mesh

    # -- capability gate ----------------------------------------------------
    @staticmethod
    def supports(codec) -> bool:
        """Batched entry points exist and the chunk layout is the plain
        positional one (a chunk remapping would decouple shard ids from
        matrix rows, which the batch kernels do not model) -- unless
        the codec declares ``batch_chunk_mapping_ok``: the flat linear
        family (ec/linear_codec.py) keys its generator by position and
        the StripeInfo paths place its chunks via ``chunk_index``, so
        mapped layouts (lrc) coalesce safely."""
        return (hasattr(codec, "encode_batch")
                and hasattr(codec, "decode_batch")
                and getattr(codec, "encode_matrix", None) is not None
                and (not codec.get_chunk_mapping()
                     or getattr(codec, "batch_chunk_mapping_ok",
                                False)))

    # -- submission ---------------------------------------------------------
    async def encode(self, codec, stripes: np.ndarray,
                     with_crc: bool = False):
        """(n, k, L) data chunks -> (n, m, L) parity chunks.

        With ``with_crc`` the result is ``(parity, crcs)`` where crcs
        is (n, k+m) uint32 -- the CRC32C of every data and parity chunk
        of every stripe, computed in the launch itself when the codec
        exposes ``encode_batch_crc`` (device-fused; no host re-scan of
        bytes the accelerator just touched) and by one host
        ``crc32c_rows`` pass otherwise.  Callers fold them into
        whole-shard CRCs with ``fold_chunk_crcs``.
        """
        return await self._submit("encode", codec, stripes, (),
                                  want_crc=with_crc)

    async def decode(self, codec, erasures: tuple[int, ...],
                     survivors: np.ndarray) -> np.ndarray:
        """(n, k, L) surviving chunks (decode-index order, the same
        contract as ``decode_batch``) -> (n, len(erasures), L)."""
        return await self._submit("decode", codec, survivors,
                                  tuple(int(e) for e in erasures))

    async def rmw(self, codec, old_parity: np.ndarray,
                  delta: np.ndarray) -> np.ndarray:
        """Delta-encoded partial-stripe parity update: (n, m, L) old
        parity + (n, k, L) data delta (zeros outside the written
        range) -> (n, m, L) new parity = old XOR encode(delta), by GF
        linearity.  Coalesces across concurrently-submitting ops like
        encode/decode; through the mesh the old-parity device buffer is
        donated and ALIASED in place (MeshCodec.rmw), so the update
        never holds two parity copies."""
        old_parity = np.ascontiguousarray(old_parity, np.uint8)
        assert old_parity.ndim == 3, old_parity.shape
        return await self._submit("rmw", codec, delta, (),
                                  old=old_parity)

    def note_fallback(self) -> None:
        """A caller took the per-op path for a non-batch codec."""
        if self.perf is not None:
            self.perf.inc("fallback_ops")

    def note_rmw(self, delta: bool) -> None:
        """A partial-stripe write run took the delta path (rmw launch)
        or fell back to a full re-encode."""
        if self.perf is not None:
            self.perf.inc("rmw_delta_runs" if delta
                          else "rmw_full_runs")

    async def _submit(self, kind: str, codec, arr: np.ndarray,
                      extra: tuple, want_crc: bool = False, old=None):
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        assert arr.ndim == 3, arr.shape
        if self._closed:
            # late stragglers during shutdown: launch solo
            if kind == "rmw":
                return old ^ self._launch_one("encode", codec, (), arr)
            out = self._launch_one(kind, codec, extra, arr)
            if want_crc:
                return out, self._host_chunk_crcs(arr, out)
            return out
        key = codec_signature(codec, kind, extra)
        grp = self._groups.get(key)
        if grp is None:
            grp = self._groups[key] = _Group(codec, kind, extra)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        grp.items.append((arr, fut, want_crc, old))
        grp.n_stripes += arr.shape[0]
        if grp.n_stripes >= self.max_batch:
            self._flush(key, "full")
        elif grp.task is None:
            grp.task = loop.create_task(self._linger(key, grp))
        return await fut

    # -- flush policy --------------------------------------------------------
    async def _linger(self, key: tuple, grp: _Group) -> None:
        """Wait for co-submitters, then flush.  The group grows while
        other runnable tasks reach their submit points; one full event
        loop pass with no growth means the queue drained."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.flush_timeout
        try:
            while True:
                n0 = grp.n_stripes
                await asyncio.sleep(0)
                if self._groups.get(key) is not grp:
                    return               # flushed by the size threshold
                if grp.n_stripes != n0:
                    continue             # still coalescing
                if self.eager_flush:
                    self._flush(key, "drain")
                    return
                now = loop.time()
                if now >= deadline:
                    self._flush(key, "timer")
                    return
                await asyncio.sleep(min(self.flush_timeout / 4,
                                        deadline - now))
        except asyncio.CancelledError:
            pass

    def _flush(self, key: tuple, reason: str) -> None:
        grp = self._groups.pop(key, None)
        if grp is None or not grp.items:
            return
        if not self.pipeline or self._closed:
            self._run_batch(grp, reason)
            return
        # pipelined: marshal NOW (this is exactly the host staging that
        # overlaps the in-flight launch), park the batch, and let the
        # launcher task launch it.  A full staging queue degrades to an inline
        # launch -- bounded memory, and the stall is counted so the
        # bench can see when the depth knob binds.
        if len(self._staged) >= self.staging_depth:
            self._pcount("stage_stalls")
            self._run_batch(grp, reason)
            return
        self._staged.append(self._marshal(grp, reason))
        self._pcount("staged_batches")
        if self._drive_task is None or self._drive_task.done():
            self._drive_task = asyncio.ensure_future(self._drive())

    def _pcount(self, key: str, by: int = 1) -> None:
        if self.pipe_perf is not None:
            self.pipe_perf.inc(key, by)

    async def _drive(self) -> None:
        """The staged launcher: one in-flight launch at a time.

        Dispatch is asynchronous (``out_np=False`` launches return
        device futures), so the yield between dispatch and completion
        is the overlap window -- co-submitting tasks run there and
        marshal batch N+1 while N executes on device."""
        while self._staged:
            st = self._staged.popleft()
            try:
                handle = self._dispatch(st)
            except Exception as e:
                self._fail(st, e)
                continue
            # overlap window: let submitters stage the next batch
            # while this launch is in flight on device.  Only yield
            # when someone could actually use the window (a parked
            # batch or a coalescing group) -- an unconditional yield
            # would add a scheduling pass to EVERY launch completion,
            # which under a saturated loop is pure latency.
            if self._staged or self._groups:
                await asyncio.sleep(0)
            if self._staged:
                self._pcount("inflight_overlap_windows")
            try:
                self._complete(st, handle)
            except Exception as e:
                self._fail(st, e)

    def _drain_staged(self) -> None:
        """Synchronously launch everything parked (shutdown path): no
        staged batch may outlive the batcher -- an orphaned batch is a
        wedged op."""
        if self._drive_task is not None:
            self._drive_task.cancel()
            self._drive_task = None
        while self._staged:
            st = self._staged.popleft()
            try:
                self._complete(st, self._dispatch(st))
            except Exception as e:
                self._fail(st, e)

    @staticmethod
    def _fail(st: "_Staged", e: Exception) -> None:
        for _, fut, _, _ in st.grp.items:
            if not fut.done():
                fut.set_exception(e)

    def flush_all(self, reason: str = "close") -> None:
        for key in list(self._groups):
            self._flush(key, reason)

    def close(self) -> None:
        """Launch whatever is pending so in-flight ops complete, then
        refuse further coalescing (stragglers launch solo)."""
        self._closed = True
        self.flush_all("close")
        self._drain_staged()

    # -- the launch ----------------------------------------------------------
    def _launch_one(self, kind: str, codec, extra: tuple,
                    arr: np.ndarray, out_np: bool = True):
        if kind == "encode":
            if not out_np:      # deferred: one asarray at completion
                return codec.encode_batch(arr, out_np=False)
            return np.asarray(codec.encode_batch(arr, out_np=True))
        if not out_np:
            return codec.decode_batch(list(extra), arr, out_np=False)
        return np.asarray(codec.decode_batch(list(extra), arr,
                                             out_np=True))

    @staticmethod
    def _host_chunk_crcs(data: np.ndarray,
                         out: np.ndarray) -> np.ndarray:
        """Host fallback for codecs without a fused CRC entry point:
        still ONE batched pass over all chunks, never per-buffer."""
        from ..ops.crc32c_batch import crc32c_rows
        b, k, lane = data.shape
        r = out.shape[1]
        crcs = crc32c_rows(np.concatenate(
            [data.reshape(b * k, lane), out.reshape(b * r, lane)]))
        return np.concatenate([crcs[:b * k].reshape(b, k),
                               crcs[b * k:].reshape(b, r)], axis=1)

    def _run_batch(self, grp: _Group, reason: str) -> None:
        """The serial chain (kill-switch path and shutdown drain):
        marshal -> dispatch -> complete inline.  The pipelined launcher
        runs the SAME three functions with a yield between dispatch
        and complete -- byte parity between the two modes is by
        construction, not by test luck."""
        st = self._marshal(grp, reason)
        try:
            self._complete(st, self._dispatch(st))
        except Exception as e:
            self._fail(st, e)

    def _marshal(self, grp: _Group, reason: str) -> _Staged:
        """Host staging: pad and stack the coalesced submissions into
        one (b, k, lane) launch batch (plus the old-parity batch for
        rmw).  This is the work that overlaps the in-flight launch."""
        from ..ops.gf2kernels import bucket_batch
        items = grp.items
        k = items[0][0].shape[1]
        lane = max(a.shape[2] for a, _, _, _ in items)
        total = sum(a.shape[0] for a, _, _, _ in items)
        mesh = self._mesh_for(grp.codec)
        b = mesh.pad_batch(total) if mesh is not None \
            else bucket_batch(total)
        payload = sum(a.size for a, _, _, _ in items)
        if len(items) == 1 and b == total:
            batch = items[0][0]
        else:
            batch = np.zeros((b, k, lane), np.uint8)
            row = 0
            for a, _, _, _ in items:
                n, _, l = a.shape
                batch[row:row + n, :, :l] = a
                row += n
        old_batch = None
        if grp.kind == "rmw":
            # the old-parity side rides the same padding: zero delta
            # rows encode to zero, so padded parity passes through
            m_dim = items[0][3].shape[1]
            if len(items) == 1 and b == total:
                old_batch = items[0][3]
            else:
                old_batch = np.zeros((b, m_dim, lane), np.uint8)
                row = 0
                for a, _, _, old in items:
                    n, _, l = a.shape
                    old_batch[row:row + n, :, :l] = old
                    row += n
        want_crc = any(w for _, _, w, _ in items)
        return _Staged(grp, reason, batch, old_batch, want_crc,
                       lane, total, b, payload, mesh)

    def _dispatch(self, st: _Staged) -> tuple:
        """Device dispatch WITHOUT materialization: launches return
        device futures (``out_np=False``), so control comes back to
        the event loop while the device works.  Returns
        (mode, out, crcs, xor_stats0); ``_complete`` pays the single
        asarray."""
        grp, batch, old_batch = st.grp, st.batch, st.old_batch
        want_crc, mesh = st.want_crc, st.mesh
        # scheduled-engine observability: the XOR-schedule compiler
        # (ops/xor_schedule.py) counts process-wide; sampling the
        # delta around THIS launch keeps the ec_batch counters live
        # on every scheduled launch (the perf-coherence contract)
        xor_stats0 = None
        if self.perf is not None:
            from ..ops.xor_schedule import STATS as XOR_STATS
            xor_stats0 = XOR_STATS.snapshot()
        crcs = None
        if mesh is not None:
            # the data plane: ONE launch for the whole coalesced batch,
            # fused CRCs riding the same device round trip when wanted.
            # A failure raises to the caller, which fails the waiters.
            if grp.kind == "rmw":
                out = mesh.rmw(grp.codec, old_batch, batch, out_np=False)
            elif grp.kind == "encode" and want_crc \
                    and hasattr(grp.codec, "encode_batch_crc") \
                    and self._fused_crc_ok():
                out, crcs = mesh.encode(grp.codec, batch, with_crc=True,
                                        out_np=False)
                if self.perf is not None:
                    self.perf.inc("crc_fused_launches")
            elif grp.kind == "encode":
                out = mesh.encode(grp.codec, batch, out_np=False)
            else:
                out = mesh.decode(grp.codec, grp.extra, batch, out_np=False)
            return ("plain", out, crcs, xor_stats0)
        if grp.kind == "rmw":
            # single-device delta: parity' = parity ^ encode(delta),
            # the XOR applied at completion on the materialized encode
            enc = self._launch_one("encode", grp.codec, (), batch,
                                   out_np=False)
            return ("rmw_host", enc, None, xor_stats0)
        if want_crc and grp.kind == "encode" \
                and hasattr(grp.codec, "encode_batch_crc") \
                and self._fused_crc_ok():
            out, crcs = grp.codec.encode_batch_crc(batch)
            if self.perf is not None:
                self.perf.inc("crc_fused_launches")
            return ("plain", out, crcs, xor_stats0)
        out = self._launch_one(grp.kind, grp.codec, grp.extra, batch,
                               out_np=False)
        return ("plain", out, crcs, xor_stats0)

    def _complete(self, st: _Staged, handle: tuple) -> None:
        """Materialize the launch (the single post-launch host hop),
        fan results back to the per-op futures, bump the counters."""
        from ..ops.crc32c_batch import to_uint32
        grp, items = st.grp, st.grp.items
        mode, out, crcs, xor_stats0 = handle
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)
        if mode == "rmw_host":
            out = st.old_batch ^ out
        if crcs is not None:
            crcs = to_uint32(crcs)
        elif st.want_crc:
            crcs = self._host_chunk_crcs(st.batch, out)
            if self.perf is not None:
                self.perf.inc("crc_host_batches")
        row = 0
        lane = st.lane
        self.launch_shapes[(grp.kind, tuple(st.batch.shape),
                            tuple(grp.extra))] += 1
        for a, fut, w, _ in items:
            n, _, l = a.shape
            if not fut.done():
                res = out[row:row + n, :, :l]
                if w:
                    item_crcs = crcs[row:row + n]
                    if l < lane:
                        # chunk CRCs were computed at the padded lane
                        # width; zero-extension is invertible, so strip
                        # it instead of re-hashing the bytes
                        from ..ops.crc32c_batch import crc32c_strip_zeros
                        item_crcs = crc32c_strip_zeros(item_crcs,
                                                       lane - l)
                    fut.set_result((res, item_crcs))
                else:
                    fut.set_result(res)
            row += n
        if self.perf is not None:
            self.perf.inc("batches")
            self.perf.inc(f"{grp.kind}_launches")
            self.perf.inc("stripes", st.total)
            self.perf.inc("ops_coalesced", len(items))
            self.perf.inc("pad_waste_bytes",
                          st.b * st.batch.shape[1] * lane - st.payload)
            self.perf.inc(f"flush_{st.reason}")
            self.perf.hist_sample("stripes_per_batch", st.total)
            if xor_stats0 is not None:
                from ..ops.xor_schedule import STATS as XOR_STATS
                l1, f1, t1 = XOR_STATS.snapshot()
                l0, f0, t0 = xor_stats0
                self.perf.inc("xor_sched_launches", l1 - l0)
                self.perf.inc("xor_sched_fallbacks", f1 - f0)
                self.perf.inc("xor_terms_saved", t1 - t0)

    @staticmethod
    def _fused_crc_ok() -> bool:
        from ..ops.crc32c_batch import fused_enabled
        return fused_enabled()
