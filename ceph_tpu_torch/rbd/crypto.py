"""librbd image encryption: AES-256-XTS under the I/O path.

src/librbd/crypto role (CryptoObjectDispatch + luks EncryptionFormat):
a random DATA key encrypts every data-object sector with AES-XTS,
tweaked by (object id, sector number) so identical plaintext never
repeats ciphertext; the data key is wrapped (AES-GCM) by a key
derived from the user's passphrase (PBKDF2), and the envelope lives
on the image header -- so the passphrase can change without
re-encrypting data, and an image is unreadable without it.

The crypto sits BELOW the ObjectCacher (the cache holds plaintext,
exactly the reference's dispatch-layer ordering) and above the ioctx:
``CryptoIoCtx`` is a duck-typed ioctx whose object read/write
decrypt/encrypt transparently, read-modify-writing partial sectors
(safe under the image's exclusive single-writer lock).

Port of ``ceph_tpu/rbd/crypto.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import hashlib
import json
import os

SECTOR = 4096
ENVELOPE_XATTR = "rbd.encryption"
_KDF_ITERS = 200_000


class WrongPassphrase(Exception):
    pass


def _kek(passphrase: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt,
                               _KDF_ITERS)


def make_envelope(passphrase: str) -> tuple[dict, bytes]:
    """(header envelope, raw 64-byte XTS data key)."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    data_key = os.urandom(64)            # XTS = two 256-bit halves
    salt = os.urandom(16)
    nonce = os.urandom(12)
    wrapped = AESGCM(_kek(passphrase, salt)).encrypt(
        nonce, data_key, b"rbd-luks")
    return ({"cipher": "aes-256-xts", "kdf": "pbkdf2-sha256",
             "iters": _KDF_ITERS, "salt": salt.hex(),
             "nonce": nonce.hex(), "wrapped_key": wrapped.hex(),
             "sector": SECTOR}, data_key)


def unwrap_key(envelope: dict, passphrase: str) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    try:
        return AESGCM(
            _kek(passphrase, bytes.fromhex(envelope["salt"]))
        ).decrypt(bytes.fromhex(envelope["nonce"]),
                  bytes.fromhex(envelope["wrapped_key"]), b"rbd-luks")
    except Exception as e:
        raise WrongPassphrase("cannot unwrap data key "
                              "(wrong passphrase?)") from e


class CryptoIoCtx:
    """Duck-typed ioctx: object data reads/writes pass through
    AES-256-XTS at sector granularity; everything else passes through
    untouched (header/omap ops stay plaintext metadata)."""

    def __init__(self, ioctx, data_key: bytes) -> None:
        self.ioctx = ioctx
        self._key = data_key

    def _xts(self, oid: str, sector: int):
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)
        tweak = (hashlib.md5(oid.encode()).digest()[:8]
                 + sector.to_bytes(8, "little"))
        return Cipher(algorithms.AES(self._key), modes.XTS(tweak))

    def _enc(self, oid: str, sector: int, plain: bytes) -> bytes:
        e = self._xts(oid, sector).encryptor()
        return e.update(plain) + e.finalize()

    def _dec(self, oid: str, sector: int, ct: bytes) -> bytes:
        d = self._xts(oid, sector).decryptor()
        return d.update(ct) + d.finalize()

    async def read(self, oid, length=None, offset: int = 0, **kw):
        if length is None:
            raw = await self.ioctx.read(oid, **kw)
            end = len(raw)
            s0 = 0
        else:
            s0 = offset // SECTOR
            end = offset + length
            raw = await self.ioctx.read(
                oid, length=((end + SECTOR - 1) // SECTOR * SECTOR
                             - s0 * SECTOR),
                offset=s0 * SECTOR, **kw)
        out = bytearray()
        zero = b"\x00" * SECTOR
        for i in range(0, len(raw), SECTOR):
            chunk = bytes(raw[i:i + SECTOR])
            if chunk == zero:
                # a HOLE: sparse objects zero-fill unwritten ranges
                # below EOF, and decrypting plaintext zeros would
                # return garbage.  Real ciphertext is never all-zero
                # (XTS of any sector; p ~ 2^-32768), so all-zero means
                # unwritten -- the sparse-read extent skip the
                # reference's crypto dispatch does, by value
                out += chunk
            elif len(chunk) == SECTOR:
                out += self._dec(oid, s0 + i // SECTOR, chunk)
            elif chunk:
                # a short tail only happens on the object's final
                # partial sector, which was stored padded; decrypt of
                # a non-multiple is impossible in XTS<16B, so pad-read
                out += self._dec(oid, s0 + i // SECTOR,
                                 chunk.ljust(SECTOR, b"\x00"))[
                                     :len(chunk)]
        if length is None:
            return bytes(out)
        return bytes(out[offset - s0 * SECTOR:
                         offset - s0 * SECTOR + length])

    async def write(self, oid, data, offset: int = 0):
        end = offset + len(data)
        s0, s1 = offset // SECTOR, (end + SECTOR - 1) // SECTOR
        aligned = bytearray((s1 - s0) * SECTOR)
        # partial head/tail sectors: read-modify-write the plaintext
        # (single writer under the exclusive lock).  A missing object
        # is all zeros here; plain read() still propagates ENOENT so
        # the image layer's hole/parent fallback keeps working
        if offset % SECTOR or end % SECTOR:
            from ..client.rados import RadosError
            try:
                existing = await self.read(
                    oid, length=len(aligned), offset=s0 * SECTOR)
                aligned[:len(existing)] = existing
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
        aligned[offset - s0 * SECTOR:end - s0 * SECTOR] = data
        ct = bytearray()
        for i in range(0, len(aligned), SECTOR):
            ct += self._enc(oid, s0 + i // SECTOR,
                            bytes(aligned[i:i + SECTOR]))
        # store full padded sectors; logical size tracking lives above
        # (image size / striper size xattrs), so trailing zero pad is
        # invisible to readers
        await self.ioctx.write(oid, bytes(ct), offset=s0 * SECTOR)
        return len(data)

    def encrypt_full(self, oid: str, data: bytes) -> bytes:
        """Sector-encrypt a whole-object payload starting at offset 0
        (for atomic cls copyup, which bypasses the write path)."""
        pad = (len(data) + SECTOR - 1) // SECTOR * SECTOR
        buf = bytes(data).ljust(pad, b"\x00")
        ct = bytearray()
        for i in range(0, pad, SECTOR):
            ct += self._enc(oid, i // SECTOR, buf[i:i + SECTOR])
        return bytes(ct)

    async def truncate(self, oid, size: int):
        # ciphertext is stored in whole sectors: cut on the next
        # sector boundary, then RE-ENCRYPT the kept sector's tail as
        # zeros -- otherwise stale pre-shrink bytes resurface after a
        # later grow (the plain path's exact truncate + zero-pad
        # guarantees zeros there)
        aligned = (size + SECTOR - 1) // SECTOR * SECTOR
        out = await self.ioctx.truncate(oid, aligned)
        if aligned != size:
            await self.write(oid, b"\x00" * (aligned - size),
                             offset=size)
        return out

    async def zero(self, oid, off: int, n: int):
        """Deallocate/zero a range.  Whole sectors go down as RAW
        zeros (which reads already interpret as holes -- see the
        all-zero heuristic), so discard stays a deallocation; partial
        edge sectors must be re-encrypted with zeroed bytes."""
        from ..client.rados import RadosError
        end = off + n
        s_start = (off + SECTOR - 1) // SECTOR * SECTOR
        s_end = end // SECTOR * SECTOR
        try:
            if off % SECTOR and off < min(s_start, end):
                await self.write(oid, b"\x00" * (min(s_start, end)
                                                 - off), offset=off)
            if s_end > s_start:
                await self.ioctx.zero(oid, s_start, s_end - s_start)
            if end % SECTOR and end > max(s_end, off) \
                    and s_end >= s_start:
                await self.write(oid, b"\x00" * (end - max(s_end,
                                                           off)),
                                 offset=max(s_end, off))
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise            # nothing there: discard is a no-op

    def __getattr__(self, name):
        return getattr(self.ioctx, name)


async def format_encryption(ioctx, header_oid: str,
                            passphrase: str) -> bytes:
    """Write the LUKS-style envelope onto the image header; returns
    the unwrapped data key.  Must run before any data is written."""
    envelope, key = make_envelope(passphrase)
    await ioctx.set_xattr(header_oid, ENVELOPE_XATTR,
                          json.dumps(envelope).encode())
    return key


async def load_key(ioctx, header_oid: str,
                   passphrase: str) -> bytes | None:
    """The image's data key, or None when the image is unencrypted."""
    from ..client.rados import RadosError
    try:
        raw = await ioctx.get_xattr(header_oid, ENVELOPE_XATTR)
    except RadosError:
        return None
    if raw is None:
        return None
    return unwrap_key(json.loads(raw), passphrase)
