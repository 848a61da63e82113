"""denc: versioned, bounded binary encoding (src/include/denc.h analog).

Port of ``ceph_tpu/common/denc.py``, the pure-Python codec: the
reference's C value codec (``native/denc_value.cc``) is byte-identical to
it and is not carried.  BlockStore encodes its onodes with it.

The reference serializes every persistent/wire type with a tiny
discipline that buys decades of compat:

  ENCODE_START(v, compat, bl)  -> struct_v u8 | struct_compat u8 | len u32
  ...fixed-width LE fields...
  ENCODE_FINISH                -> patches len

  DECODE_START(v, p)  -> fails if struct_compat > the code's version,
  DECODE_FINISH       -> skips unread trailing bytes (a NEWER encoder's
                         extra fields are silently ignored)

That skip-unknown-tail is the entire forward-compat story: old code
reads new encodings (up to struct_compat), new code reads old ones
(version checks gate new fields).
"""

from __future__ import annotations

import struct


class DencError(ValueError):
    # subclasses ValueError: the messenger read loops treat any
    # ValueError as a framing error (close/reconnect), and a malformed
    # denc envelope must take that path exactly as bad JSON used to
    pass


class IncompatibleVersion(DencError):
    pass


def denc_bytes(obj) -> bytes:
    """Encode one denc-capable object (has .denc(enc)) to bytes."""
    enc = Encoder()
    obj.denc(enc)
    return enc.bytes()


class Encoder:
    def __init__(self) -> None:
        self.buf = bytearray()
        self._starts: list[int] = []

    # -- primitives (fixed-width little-endian, like denc) ------------------
    def u8(self, v: int) -> "Encoder":
        self.buf.append(v & 0xFF)
        return self

    def u16(self, v: int) -> "Encoder":
        self.buf += struct.pack("<H", v & 0xFFFF)
        return self

    def u32(self, v: int) -> "Encoder":
        self.buf += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def u64(self, v: int) -> "Encoder":
        self.buf += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)
        return self

    def i64(self, v: int) -> "Encoder":
        self.buf += struct.pack("<q", v)
        return self

    def f64(self, v: float) -> "Encoder":
        self.buf += struct.pack("<d", v)
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    def blob(self, v: bytes) -> "Encoder":
        self.u32(len(v))
        self.buf += v
        return self

    def string(self, v: str) -> "Encoder":
        return self.blob(v.encode("utf-8"))

    def list(self, items, fn) -> "Encoder":
        self.u32(len(items))
        for it in items:
            fn(self, it)
        return self

    def map(self, d, kfn, vfn) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):        # deterministic byte output
            kfn(self, k)
            vfn(self, d[k])
        return self

    def optional(self, v, fn) -> "Encoder":
        self.boolean(v is not None)
        if v is not None:
            fn(self, v)
        return self

    # -- generic tagged value (JSON data model, binary bytes) ---------------
    def value(self, v) -> "Encoder":
        """Tagged encoding of an arbitrary JSON-shaped value: the wire
        meta's replacement for json.dumps.  Deliberately mirrors
        JSON's semantics so the switch is invisible to message
        handlers: dict keys coerce to strings, tuples become lists.
        Raises DencError on types JSON could not carry either."""
        return self._value_py(v)

    def _value_py(self, v, depth: int = 0) -> "Encoder":
        if depth > 200:
            # the reference's cap: both sides agree on what is encodable
            raise DencError("value nesting too deep")
        if v is None:
            self.u8(0)
        elif v is True:
            self.u8(1)
        elif v is False:
            self.u8(2)
        elif isinstance(v, int):
            if -(1 << 63) <= v < (1 << 63):
                self.u8(3)
                self.i64(v)
            else:                        # python bignum: decimal text
                self.u8(9)
                self.string(str(v))
        elif isinstance(v, float):
            self.u8(4)
            self.f64(v)
        elif isinstance(v, str):
            self.u8(5)
            self.string(v)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            self.u8(6)
            self.blob(bytes(v))
        elif isinstance(v, (list, tuple)):
            self.u8(7)
            self.u32(len(v))
            for it in v:
                self._value_py(it, depth + 1)
        elif isinstance(v, dict):
            self.u8(8)
            self.u32(len(v))
            for k, vv in v.items():      # insertion order, like JSON
                if not isinstance(k, str):
                    k = str(k)           # json.dumps key coercion
                self.string(k)
                self._value_py(vv, depth + 1)
        else:
            raise DencError(
                f"unencodable value type {type(v).__name__}")
        return self

    # -- versioned envelope --------------------------------------------------
    def start(self, v: int, compat: int) -> "Encoder":
        """ENCODE_START: version byte, compat byte, length placeholder."""
        self.u8(v).u8(compat)
        self._starts.append(len(self.buf))
        self.u32(0)
        return self

    def finish(self) -> "Encoder":
        """ENCODE_FINISH: patch the length of the innermost envelope."""
        at = self._starts.pop()
        ln = len(self.buf) - at - 4
        self.buf[at:at + 4] = struct.pack("<I", ln)
        return self

    def bytes(self) -> bytes:
        if self._starts:
            raise DencError("unbalanced start/finish")
        return bytes(self.buf)


class Decoder:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = memoryview(data)
        self.pos = pos
        self._ends: list[int] = []

    def _take(self, n: int) -> memoryview:
        end = self._ends[-1] if self._ends else len(self.data)
        if self.pos + n > end:
            raise DencError(
                f"decode past end ({self.pos}+{n} > {end})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def blob(self) -> bytes:
        return bytes(self._take(self.u32()))

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def list(self, fn) -> list:
        return [fn(self) for _ in range(self.u32())]

    def map(self, kfn, vfn) -> dict:
        return {kfn(self): vfn(self) for _ in range(self.u32())}

    def optional(self, fn):
        return fn(self) if self.boolean() else None

    # -- generic tagged value ------------------------------------------------
    def value(self):
        return self._value_py()

    def _value_py(self, depth: int = 0):
        if depth > 200:
            # the reference's cap, and a RecursionError from a
            # hostile deep payload would not be a ValueError (the
            # framing-error class the read loop handles)
            raise DencError("value nesting too deep")
        tag = self.u8()
        if tag == 0:
            return None
        if tag == 1:
            return True
        if tag == 2:
            return False
        if tag == 3:
            return self.i64()
        if tag == 4:
            return self.f64()
        if tag == 5:
            return self.string()
        if tag == 6:
            return self.blob()
        if tag == 7:
            return [self._value_py(depth + 1)
                    for _ in range(self.u32())]
        if tag == 8:
            return {self.string(): self._value_py(depth + 1)
                    for _ in range(self.u32())}
        if tag == 9:
            return int(self.string())
        raise DencError(f"bad value tag {tag}")

    # -- versioned envelope --------------------------------------------------
    def start(self, supported: int) -> int:
        """DECODE_START: returns struct_v; raises when the encoder
        declared compat above what this code supports."""
        v = self.u8()
        compat = self.u8()
        ln = self.u32()
        if compat > supported:
            raise IncompatibleVersion(
                f"encoding requires v>={compat}, code supports "
                f"{supported}")
        if ln > self.remaining():
            # an envelope may never claim bytes beyond its parent (or
            # the buffer): a lying length would let reads walk into
            # sibling data instead of failing
            raise DencError(
                f"envelope length {ln} exceeds remaining "
                f"{self.remaining()}")
        self._ends.append(self.pos + ln)
        return v

    def finish(self) -> None:
        """DECODE_FINISH: skip unread tail (newer encoder's fields)."""
        self.pos = self._ends.pop()

    def remaining(self) -> int:
        end = self._ends[-1] if self._ends else len(self.data)
        return end - self.pos
