"""Wire message model and v2-lite frame codec.

Frame = magic | u32 meta_len | meta(denc) | segments | u32 crc32c.
The meta envelope is the repo's own versioned denc encoding
(common/denc.py), NOT json: hot-path types (osd_op, rep_op, ping --
msg/wire_types.py) get explicit MOSDOp-style field layouts, everything
else rides the generic tagged-value encoding, and a json escape hatch
remains only for payloads denc cannot express.  Raw binary segments
stay zero-copy -- the same meta/payload segment split ProtocolV2
frames use (4 segments + epilogue crcs, src/msg/async/frames_v2.cc).

meta envelope (denc, struct_v 1):
  string t | u64 seq | string from | u8 kind | blob payload |
  list<u32> seg_lens
where kind selects the payload codec: 0 generic value, 1 json
(escape hatch), 2 typed (wire_types.WIRE_CODECS[t]).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Any

from ..common.denc import Decoder, DencError, Encoder
from ..native import crc32c

MAGIC = b"CTv3"
MAX_FRAME = 256 << 20

KIND_VALUE = 0
KIND_JSON = 1
KIND_TYPED = 2


@dataclass
class Message:
    type: str
    data: dict[str, Any] = field(default_factory=dict)
    segments: list[bytes] = field(default_factory=list)
    seq: int = 0
    from_name: str = ""

    def encode(self) -> bytes:
        from .wire_types import WIRE_CODECS
        payload = Encoder()
        codec = WIRE_CODECS.get(self.type)
        try:
            if codec is not None:
                kind = KIND_TYPED
                codec[0](payload, self.data)
            else:
                kind = KIND_VALUE
                payload.value(self.data)
        except (DencError, TypeError, OverflowError) as denc_err:
            # escape hatch: a payload the denc codecs (typed OR
            # generic) cannot express falls back to json -- best
            # effort, since json's data model is a subset; if json
            # can't carry it either, the original error surfaces
            try:
                blob = json.dumps(self.data).encode()
            except (TypeError, ValueError):
                raise denc_err
            kind = KIND_JSON
            payload = Encoder()
            payload.blob(blob)
        # the envelope (ENCODE_START(1, 1) | string t | u64 seq | string
        # from | u8 kind | blob payload | list<u32> seg_lens) packed in
        # one join: the Encoder's calls a field cost more than the field
        tb, fb = self.type.encode("utf-8"), self.from_name.encode("utf-8")
        pb = payload.bytes()
        inner = b"".join((
            _U32(len(tb)), tb, _U64(self.seq & 0xFFFFFFFFFFFFFFFF),
            _U32(len(fb)), fb, _U8(kind), _U32(len(pb)), pb,
            _U32(len(self.segments)),
            *[_U32(len(seg)) for seg in self.segments]))
        mb = b"\x01\x01" + _U32(len(inner)) + inner
        body = mb + b"".join(self.segments)
        crc = crc32c(body) & 0xFFFFFFFF
        return MAGIC + struct.pack("<I", len(mb)) + body + struct.pack(
            "<I", crc)

    @classmethod
    def decode(cls, buf: bytes) -> "Message":
        if buf[:4] != MAGIC:
            raise ValueError("bad magic")
        (meta_len,) = struct.unpack_from("<I", buf, 4)
        mb = buf[8:8 + meta_len]
        (crc,) = struct.unpack_from("<I", buf, len(buf) - 4)
        body = buf[8:len(buf) - 4]
        if (crc32c(body) & 0xFFFFFFFF) != crc:
            raise ValueError("frame crc mismatch")
        mtype, seq, from_name, data, seg_lens = _decode_meta(mb)
        segments = []
        off = 8 + meta_len
        for ln in seg_lens:
            segments.append(buf[off:off + ln])
            off += ln
        return cls(type=mtype, data=data, segments=segments,
                   seq=seq, from_name=from_name)


_U8 = struct.Struct("<B").pack
_U32 = struct.Struct("<I").pack
_U64 = struct.Struct("<Q").pack
_unpack_u32 = struct.Struct("<I").unpack_from
_unpack_u64 = struct.Struct("<Q").unpack_from


def _split_meta(mb) -> tuple | None:
    """The envelope's fields read straight off the buffer, or None for
    anything but a well-formed version 1 envelope (``_decode_meta``'s
    Decoder then reads it and raises what it raises)."""
    if len(mb) < 6 or mb[1] > 1:
        return None
    end = 6 + _unpack_u32(mb, 2)[0]
    if end > len(mb):
        return None

    def blob(pos: int) -> tuple:
        n = _unpack_u32(mb, pos)[0]
        if pos + 4 + n > end:
            raise IndexError
        return mb[pos + 4:pos + 4 + n], pos + 4 + n
    try:
        mtype, pos = blob(6)
        if pos + 8 > end:
            return None
        seq = _unpack_u64(mb, pos)[0]
        from_name, pos = blob(pos + 8)
        if pos + 1 > end:
            return None
        kind = mb[pos]
        payload, pos = blob(pos + 1)
        if pos + 4 > end:
            return None
        count = _unpack_u32(mb, pos)[0]
        if pos + 4 + 4 * count > end:
            return None
        seg_lens = list(struct.unpack_from(f"<{count}I", mb, pos + 4))
        return (str(mtype, "utf-8"), seq, str(from_name, "utf-8"), kind,
                bytes(payload), seg_lens)
    except (struct.error, UnicodeDecodeError, IndexError):
        return None


def _decode_meta(mb) -> tuple:
    from .wire_types import WIRE_CODECS
    fields = _split_meta(mb)
    if fields is not None:
        mtype, seq, from_name, kind, payload, seg_lens = fields
        return _decode_payload(WIRE_CODECS, mtype, seq, from_name, kind,
                               payload, seg_lens)
    dec = Decoder(mb)
    dec.start(1)
    mtype = dec.string()
    seq = dec.u64()
    from_name = dec.string()
    kind = dec.u8()
    payload = dec.blob()
    seg_lens = dec.list(Decoder.u32)
    dec.finish()
    return _decode_payload(WIRE_CODECS, mtype, seq, from_name, kind, payload,
                           seg_lens)


def _decode_payload(WIRE_CODECS, mtype, seq, from_name, kind, payload,
                    seg_lens) -> tuple:
    if kind == KIND_TYPED:
        codec = WIRE_CODECS.get(mtype)
        if codec is None:
            raise ValueError(f"typed payload for unknown type {mtype}")
        data = codec[1](Decoder(payload))
    elif kind == KIND_VALUE:
        data = Decoder(payload).value()
    elif kind == KIND_JSON:
        data = json.loads(Decoder(payload).blob())
    else:
        raise ValueError(f"bad meta kind {kind}")
    return mtype, seq, from_name, data, seg_lens


COMP_MAGIC = b"CTvC"     # on-wire compressed frame (compression_onwire)
SEC_MAGIC = b"CTvE"      # AES-GCM encrypted frame (crypto_onwire secure mode)
COMPRESS_THRESHOLD = 1024
# a plain frame may carry meta and segments EACH up to MAX_FRAME; the
# wrapped paths must accept at least that (a tighter cap would reject
# on receive a frame the sender legally built -> teardown/replay loop)
MAX_WRAPPED = 2 * MAX_FRAME + 65536
OFFLOAD_THRESHOLD = 1 << 20     # executor offload for >1 MiB transforms


def _parse_plain(buf: bytes) -> bytes:
    if buf[:4] != MAGIC:
        raise ValueError("bad magic")
    return buf


def wrap_frame(buf: bytes, compressor=None, aead=None) -> bytes:
    """Apply the connection's negotiated on-wire transforms.

    compress-then-encrypt, as ProtocolV2 layers compression inside the
    secure session (compression_onwire.cc / crypto_onwire.cc); the
    compressed form is only used when it actually shrinks the frame.
    """
    if compressor is not None and len(buf) > COMPRESS_THRESHOLD:
        comp = compressor.compress(buf)
        if len(comp) < len(buf):
            buf = (COMP_MAGIC + struct.pack("<II", len(buf), len(comp))
                   + comp)
    if aead is not None:
        import os as _os
        nonce = _os.urandom(12)
        ct = aead.encrypt(nonce, buf, b"")
        buf = SEC_MAGIC + struct.pack("<I", len(ct)) + nonce + ct
    return buf


def unwrap_frame(buf: bytes, compressor=None) -> bytes:
    """Undo COMP wrapping of an in-memory frame (post-decryption)."""
    if buf[:4] == COMP_MAGIC:
        raw_len, comp_len = struct.unpack_from("<II", buf, 4)
        if raw_len > MAX_WRAPPED:
            raise ValueError("oversized compressed frame")
        if compressor is None:
            raise ValueError("compressed frame on a plain connection")
        try:
            # bounded: output capped at the declared raw_len so a
            # bomb frame fails before materializing, not after
            out = compressor.decompress(buf[12:12 + comp_len],
                                        max_length=raw_len)
        except Exception as e:
            # corrupt input must look like any other framing error so
            # the read loop's reconnect/teardown path handles it
            raise ValueError(f"frame decompress failed: {e}") from e
        if len(out) != raw_len:
            raise ValueError("compressed frame length mismatch")
        return _parse_plain(out)
    return _parse_plain(buf)


async def read_frame(reader, compressor=None, aead=None) -> bytes:
    """Read one full (plain) frame from an asyncio StreamReader,
    transparently unwrapping the connection's negotiated encryption
    and compression layers."""
    magic = await reader.readexactly(4)
    if aead is not None and magic != SEC_MAGIC:
        # a secure connection must never accept plaintext: an injected
        # cleartext frame would bypass the channel's authentication
        raise ValueError("plaintext frame on a secure connection")
    if magic == SEC_MAGIC:
        if aead is None:
            raise ValueError("encrypted frame on a plain connection")
        (ct_len,) = struct.unpack("<I", await reader.readexactly(4))
        if ct_len > MAX_WRAPPED:
            raise ValueError("oversized encrypted frame")
        nonce = await reader.readexactly(12)
        ct = await reader.readexactly(ct_len)
        try:
            if ct_len > OFFLOAD_THRESHOLD:
                # big decrypts off the event loop: heartbeats must not
                # stall behind a multi-MB AES pass
                import asyncio as _asyncio
                inner = await _asyncio.get_event_loop().run_in_executor(
                    None, aead.decrypt, nonce, ct, b"")
            else:
                inner = aead.decrypt(nonce, ct, b"")
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"frame decrypt failed: {e}") from e
        return unwrap_frame(inner, compressor)
    if magic == COMP_MAGIC:
        lens = await reader.readexactly(8)
        raw_len, comp_len = struct.unpack("<II", lens)
        if max(raw_len, comp_len) > MAX_WRAPPED:
            raise ValueError("oversized compressed frame")
        comp = await reader.readexactly(comp_len)
        return unwrap_frame(magic + lens + comp, compressor)
    if magic != MAGIC:
        raise ValueError("bad magic")
    hdr = magic + await reader.readexactly(4)
    (meta_len,) = struct.unpack_from("<I", hdr, 4)
    if meta_len > MAX_FRAME:
        raise ValueError("oversized meta")
    mb = await reader.readexactly(meta_len)
    total_segs = sum(_meta_seg_lens(mb))
    if total_segs > MAX_FRAME:
        raise ValueError("oversized frame")
    rest = await reader.readexactly(total_segs + 4)
    return hdr + mb + rest


def _meta_seg_lens(mb: bytes) -> list[int]:
    """Just the segment lengths from a meta envelope (what the stream
    reader needs to size the rest of the frame)."""
    fields = _split_meta(mb)
    if fields is not None:
        return fields[5]
    dec = Decoder(mb)
    dec.start(1)
    dec.string()        # t
    dec.u64()           # seq
    dec.string()        # from
    dec.u8()            # kind
    dec._take(dec.u32())    # skip payload without materializing it
    lens = dec.list(Decoder.u32)
    dec.finish()
    return lens
