"""cephx-style ticket auth with rotating service keys.

Why: a static pre-shared key means a leaked key is forever.  This is the reference protocol's shape compressed
(src/auth/cephx/): clients prove knowledge of their ENTITY key to the
mon and receive a TICKET -- a service-key-encrypted blob carrying a
fresh session key and an expiry -- plus the session key encrypted
under their own key.  Services never learn entity keys; they validate
tickets with ROTATING service secrets (current + previous generation,
src/auth/RotatingKeyRing.h), so a stolen service key ages out in two
rotations and a stolen ticket dies at its expiry.

AES-GCM does the sealing (the reference uses AES-CBC+hmac; GCM is the
modern equivalent of seal-with-integrity).  Entity keys are the hex
strings the mon's AuthMonitor db already stores.

`cryptography` is an OPTIONAL dependency: when the wheel is absent
(minimal CI images), sealing falls back to a
stdlib AEAD -- a SHA-256 counter-mode keystream with an encrypt-then-
HMAC tag.  Same API, same blob framing (nonce || ciphertext+tag), so
the protocol shape and every failure mode (tamper, wrong key, expiry)
stay testable without the wheel.  It is NOT AES-GCM and makes no
side-channel claims; production deployments install `cryptography`
(`have_aesgcm()` says which path is live).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import time

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:                    # pragma: no cover - env detail
    AESGCM = None


def have_aesgcm() -> bool:
    """True when the real AES-GCM backend (`cryptography`) is live."""
    return AESGCM is not None


class _StreamAEAD:
    """Stdlib fallback with the AESGCM call shape: encrypt-then-MAC
    over a SHA-256 keystream.  Tag covers nonce, AAD, and ciphertext;
    constant-time compare on open."""

    _TAG = 16

    def __init__(self, key: bytes) -> None:
        self._key = key

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = bytearray()
        ctr = 0
        while len(out) < n:
            out += hashlib.sha256(
                self._key + nonce + ctr.to_bytes(8, "big")).digest()
            ctr += 1
        return bytes(out[:n])

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        return hmac.new(self._key, nonce + aad + ct,
                        hashlib.sha256).digest()[:self._TAG]

    def encrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        aad = aad or b""
        ct = bytes(a ^ b for a, b in
                   zip(data, self._keystream(nonce, len(data))))
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, blob: bytes,
                aad: bytes | None) -> bytes:
        aad = aad or b""
        if len(blob) < self._TAG:
            raise ValueError("sealed blob truncated")
        ct, tag = blob[:-self._TAG], blob[-self._TAG:]
        if not hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise ValueError("seal authentication failed")
        return bytes(a ^ b for a, b in
                     zip(ct, self._keystream(nonce, len(ct))))


def _aes(key_material: bytes):
    key = hashlib.sha256(key_material).digest()
    if AESGCM is not None:
        return AESGCM(key)
    return _StreamAEAD(key)


def seal(key_material: bytes, obj: dict) -> str:
    nonce = os.urandom(12)
    ct = _aes(key_material).encrypt(nonce,
                                    json.dumps(obj).encode(), b"")
    return (nonce + ct).hex()


def unseal(key_material: bytes, blob_hex: str) -> dict:
    raw = bytes.fromhex(blob_hex)
    out = _aes(key_material).decrypt(raw[:12], raw[12:], b"")
    return json.loads(out)


class CephxError(Exception):
    pass


class RotatingKeys:
    """Two live generations of one service's secret; the older one
    keeps in-flight tickets valid across a rotation."""

    def __init__(self, ttl: float = 3600.0) -> None:
        self.ttl = ttl
        self.gen = 0
        self.keys: dict[int, dict] = {}
        self._rotate(time.time())

    def _rotate(self, now: float) -> None:
        self.gen += 1
        self.keys[self.gen] = {"key": os.urandom(32).hex(),
                               "created": now}
        for g in [g for g in self.keys if g < self.gen - 1]:
            del self.keys[g]

    def rotate_if_due(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        if now - self.keys[self.gen]["created"] >= self.ttl:
            self._rotate(now)
            return True
        return False

    def current(self) -> tuple[int, bytes]:
        return self.gen, bytes.fromhex(self.keys[self.gen]["key"])

    def lookup(self, gen: int) -> bytes:
        entry = self.keys.get(gen)
        if entry is None:
            raise CephxError(f"service key generation {gen} retired")
        return bytes.fromhex(entry["key"])

    def to_dict(self) -> dict:
        return {"gen": self.gen,
                "keys": {str(g): dict(e)
                         for g, e in self.keys.items()}}

    @classmethod
    def from_dict(cls, d: dict, ttl: float = 3600.0) -> "RotatingKeys":
        rk = cls.__new__(cls)
        rk.ttl = ttl
        rk.gen = int(d["gen"])
        rk.keys = {int(g): dict(e) for g, e in d["keys"].items()}
        return rk


class CephxAuthority:
    """Mon-side ticket issuer (CephxServiceHandler)."""

    def __init__(self, ttl: float = 3600.0,
                 ticket_ttl: float = 600.0) -> None:
        self.ttl = ttl
        self.ticket_ttl = ticket_ttl
        self.rotating: dict[str, RotatingKeys] = {}

    def service_keys(self, service: str) -> RotatingKeys:
        rk = self.rotating.get(service)
        if rk is None:
            rk = self.rotating[service] = RotatingKeys(self.ttl)
        rk.rotate_if_due()
        return rk

    def verify_entity_proof(self, entity_key_hex: str, nonce: str,
                            proof: str) -> None:
        want = hmac.new(bytes.fromhex(entity_key_hex),
                        bytes.fromhex(nonce),
                        hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, proof):
            raise CephxError("entity proof mismatch")

    def issue_ticket(self, entity: str, entity_key_hex: str,
                     service: str,
                     now: float | None = None) -> dict:
        """Package for the client: the service-sealed ticket (opaque
        to the client) + the session key sealed under the CLIENT's
        entity key."""
        now = time.time() if now is None else now
        rk = self.service_keys(service)
        gen, skey = rk.current()
        session_key = os.urandom(32).hex()
        expires = now + self.ticket_ttl
        ticket = seal(skey, {"entity": entity,
                             "session_key": session_key,
                             "expires": expires, "gen": gen})
        for_client = seal(bytes.fromhex(entity_key_hex),
                          {"session_key": session_key,
                           "expires": expires})
        return {"service": service, "gen": gen, "ticket": ticket,
                "session": for_client, "expires": expires}


async def _auth_rpc(msgr, mon_addr, entity: str, key_hex: str,
                    service: str, req_type: str, reply_type: str,
                    mon_name: str, timeout: float) -> dict:
    """One authenticated mon round trip shared by ticket and rotating-
    key fetches: prove the entity key over a fresh nonce, correlate
    the reply by tid."""
    import asyncio
    from ..msg import Message
    q: asyncio.Queue = asyncio.Queue()
    tid = os.urandom(8).hex()

    async def d(conn, msg):
        if msg.type == reply_type and msg.data.get("tid") == tid:
            await q.put(msg.data)

    msgr.add_dispatcher(d)
    try:
        nonce = os.urandom(16).hex()
        proof = hmac.new(bytes.fromhex(key_hex),
                         bytes.fromhex(nonce),
                         hashlib.sha256).hexdigest()
        await msgr.send(tuple(mon_addr), mon_name,
                        Message(req_type,
                                {"entity": entity, "service": service,
                                 "nonce": nonce, "proof": proof,
                                 "tid": tid}))
        pkg = await asyncio.wait_for(q.get(), timeout)
    finally:
        msgr.dispatchers.remove(d)
    if pkg.get("err"):
        raise CephxError(pkg["err"])
    return pkg


async def fetch_ticket(msgr, mon_addr, entity: str, key_hex: str,
                       service: str, mon_name: str = "mon.0",
                       timeout: float = 10.0) -> dict:
    """Client side (CephxClientHandler): prove the entity key to the
    mon, receive a ticket package, unseal the session key, and install
    the ticket on the messenger so connections to `service` daemons
    authenticate with it instead of the PSK."""
    pkg = await _auth_rpc(msgr, mon_addr, entity, key_hex, service,
                          "auth_get_ticket", "auth_ticket_reply",
                          mon_name, timeout)
    sess = unseal(bytes.fromhex(key_hex), pkg["session"])
    ticket = {"gen": pkg["gen"], "ticket": pkg["ticket"],
              "session_key": sess["session_key"],
              "expires": sess["expires"]}
    msgr.tickets[service] = ticket
    return ticket


async def fetch_rotating(msgr, mon_addr, entity: str, key_hex: str,
                         service: str, mon_name: str = "mon.0",
                         timeout: float = 10.0) -> RotatingKeys:
    """Daemon side: fetch the rotating validation keys for the
    daemon's own service class (sealed under its entity key)."""
    pkg = await _auth_rpc(msgr, mon_addr, entity, key_hex, service,
                          "auth_rotating", "auth_rotating_reply",
                          mon_name, timeout)
    return RotatingKeys.from_dict(unseal(bytes.fromhex(key_hex),
                                         pkg["sealed"]))


def install_validator(msgr, holder: dict) -> None:
    """Install a messenger ticket validator reading the CURRENT keys
    from `holder["rk"]` (a mutable cell, so refreshes take effect
    without re-installing).  Returns {entity, session_key bytes} so
    the handshake can bind the connection's claimed name to the
    ticket's entity (no cross-entity impersonation)."""
    def validator(gen: int, blob_hex: str) -> dict:
        info = validate_ticket(holder["rk"], gen, blob_hex)
        return {"entity": info["entity"],
                "session_key": bytes.fromhex(info["session_key"])}
    msgr.ticket_validator = validator


def validate_ticket(rotating: RotatingKeys, gen: int, ticket_hex: str,
                    now: float | None = None) -> dict:
    """Service side: unseal with the rotating key of that generation;
    reject expired tickets.  Returns {entity, session_key, expires}."""
    now = time.time() if now is None else now
    try:
        ticket = unseal(rotating.lookup(int(gen)), ticket_hex)
    except CephxError:
        raise
    except Exception as e:
        raise CephxError(f"ticket unseal failed: {type(e).__name__}") \
            from e
    if ticket["expires"] < now:
        raise CephxError("ticket expired")
    return ticket
