"""Compressor plugins (src/compressor analog).

Same registry pattern as the erasure-code plugins (dlopen == module
import): ``Compressor.create(name)`` returns a codec with
compress/decompress, used standalone, by the messenger's on-wire
compression (msg/messenger.py), and available to stores.  Backends
map to what the runtime ships: zlib/zstd/lzma/bz2 (snappy and lz4
have no bundled python module and are gated with a clear error, the
way the reference fails a missing plugin .so).
"""

from __future__ import annotations

import bz2
import lzma
import zlib


class CompressorError(Exception):
    pass


class Compressor:
    """Base: subclasses define _compress/_decompress and name."""

    name = ""

    def compress(self, data: bytes) -> bytes:
        return self._compress(bytes(data))

    def decompress(self, data: bytes,
                   max_length: int | None = None) -> bytes:
        """``max_length`` bounds the materialized output: a crafted
        frame claiming a small raw size must fail BEFORE expanding to
        gigabytes (decompression bomb), not after."""
        try:
            if max_length is None:
                return self._decompress(bytes(data))
            out = self._decompress_bounded(bytes(data), max_length + 1)
        except CompressorError:
            raise
        except Exception as e:
            raise CompressorError(
                f"{self.name}: corrupt input: {e}") from e
        if len(out) > max_length:
            raise CompressorError(
                f"{self.name}: output exceeds declared size "
                f"{max_length}")
        return out

    def _decompress_bounded(self, data: bytes, cap: int) -> bytes:
        """Incremental decompress producing at most ``cap`` bytes."""
        raise NotImplementedError

    @staticmethod
    def create(name: str, **kw) -> "Compressor":
        cls = _PLUGINS.get(name)
        if cls is None:
            if name in ("snappy", "lz4", "zstd"):
                raise CompressorError(
                    f"compressor plugin {name}: backend library not "
                    f"available in this runtime "
                    f"(have {sorted(_PLUGINS)})")
            raise CompressorError(f"unknown compressor {name}")
        return cls(**kw)

    @staticmethod
    def available() -> list[str]:
        return sorted(_PLUGINS)


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5) -> None:
        self.level = level

    def _compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def _decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)

    def _decompress_bounded(self, data: bytes, cap: int) -> bytes:
        return zlib.decompressobj().decompress(data, cap)


try:
    import zstandard as _zstandard
except ImportError:        # registry gates the plugin cleanly below
    _zstandard = None


class ZstdCompressor(Compressor):
    name = "zstd"

    def __init__(self, level: int = 3) -> None:
        if _zstandard is None:
            raise CompressorError(
                "compressor plugin zstd: zstandard not installed")
        self._c = _zstandard.ZstdCompressor(level=level)
        self._d = _zstandard.ZstdDecompressor()

    def _compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def _decompress(self, data: bytes) -> bytes:
        return self._d.decompress(data)

    def _decompress_bounded(self, data: bytes, cap: int) -> bytes:
        # max_output_size is IGNORED when the frame header embeds a
        # content size (attacker-controlled), so the one-shot API can
        # still materialize a bomb; the stream reader honors the read
        # bound unconditionally
        import io
        out = bytearray()
        with self._d.stream_reader(io.BytesIO(data)) as r:
            while len(out) < cap:
                chunk = r.read(cap - len(out))
                if not chunk:
                    break
                out += chunk
        return bytes(out)


class LzmaCompressor(Compressor):
    name = "lzma"

    def __init__(self, preset: int = 1) -> None:
        self.preset = preset

    def _compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=self.preset)

    def _decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)

    def _decompress_bounded(self, data: bytes, cap: int) -> bytes:
        return lzma.LZMADecompressor().decompress(data, cap)


class Bz2Compressor(Compressor):
    name = "bz2"

    def __init__(self, level: int = 5) -> None:
        self.level = level

    def _compress(self, data: bytes) -> bytes:
        return bz2.compress(data, self.level)

    def _decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)

    def _decompress_bounded(self, data: bytes, cap: int) -> bytes:
        return bz2.BZ2Decompressor().decompress(data, cap)


_PLUGINS = {c.name: c for c in (ZlibCompressor, LzmaCompressor,
                                Bz2Compressor)}
if _zstandard is not None:
    _PLUGINS["zstd"] = ZstdCompressor

__all__ = ["Compressor", "CompressorError"]
