"""rjenkins1 32-bit mix hashes (scalar + numpy-vectorized).

Semantics of src/crush/hash.c:12-117 and the string hash of
src/common/ceph_hash.cc (ceph_str_hash_rjenkins), reimplemented over
explicit uint32 wraparound.  These drive every placement decision, so they
must match bit-for-bit; tests pin golden values.
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911
_M = 0xFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 13
    b = (b - c) & _M; b = (b - a) & _M; b = (b ^ (a << 8)) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 13
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 12
    b = (b - c) & _M; b = (b - a) & _M; b = (b ^ (a << 16)) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 5
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 3
    b = (b - c) & _M; b = (b - a) & _M; b = (b ^ (a << 10)) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= _M
    h = (CRUSH_HASH_SEED ^ a) & _M
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= _M; b &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= _M; b &= _M; c &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M; e &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# -- numpy vectorized versions (arrays of uint32) ---------------------------

def _mix_np(a, b, c):
    a = (a - b); a = (a - c); a ^= c >> np.uint32(13)
    b = (b - c); b = (b - a); b ^= a << np.uint32(8)
    c = (c - a); c = (c - b); c ^= b >> np.uint32(13)
    a = (a - b); a = (a - c); a ^= c >> np.uint32(12)
    b = (b - c); b = (b - a); b ^= a << np.uint32(16)
    c = (c - a); c = (c - b); c ^= b >> np.uint32(5)
    a = (a - b); a = (a - c); a ^= c >> np.uint32(3)
    b = (b - c); b = (b - a); b ^= a << np.uint32(10)
    c = (c - a); c = (c - b); c ^= b >> np.uint32(15)
    return a, b, c


def crush_hash32_2_np(a, b):
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
    x = np.full_like(a, 231232, dtype=np.uint32)
    y = np.full_like(a, 1232, dtype=np.uint32)
    a, b, h = _mix_np(a, b, h)
    x, a, h = _mix_np(x, a, h)
    b, y, h = _mix_np(b, y, h)
    return h


def crush_hash32_3_np(a, b, c):
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    c = np.asarray(c, dtype=np.uint32)
    a, b, c = np.broadcast_arrays(a, b, c)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
    x = np.full_like(h, 231232, dtype=np.uint32)
    y = np.full_like(h, 1232, dtype=np.uint32)
    a = a.copy(); b = b.copy(); c = c.copy()
    a, b, h = _mix_np(a, b, h)
    c, x, h = _mix_np(c, x, h)
    y, a, h = _mix_np(y, a, h)
    b, x, h = _mix_np(b, x, h)
    y, c, h = _mix_np(y, c, h)
    return h


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """String hash used for object-name -> placement seed."""
    a = 0x9E3779B9
    b = a
    c = 0
    length = len(data)
    i = 0
    rem = length
    while rem >= 12:
        k = data[i:i + 12]
        a = (a + (k[0] | k[1] << 8 | k[2] << 16 | k[3] << 24)) & _M
        b = (b + (k[4] | k[5] << 8 | k[6] << 16 | k[7] << 24)) & _M
        c = (c + (k[8] | k[9] << 8 | k[10] << 16 | k[11] << 24)) & _M
        a, b, c = _mix(a, b, c)
        i += 12
        rem -= 12
    c = (c + length) & _M
    k = data[i:]
    if rem >= 11: c = (c + (k[10] << 24)) & _M
    if rem >= 10: c = (c + (k[9] << 16)) & _M
    if rem >= 9:  c = (c + (k[8] << 8)) & _M
    if rem >= 8:  b = (b + (k[7] << 24)) & _M
    if rem >= 7:  b = (b + (k[6] << 16)) & _M
    if rem >= 6:  b = (b + (k[5] << 8)) & _M
    if rem >= 5:  b = (b + k[4]) & _M
    if rem >= 4:  a = (a + (k[3] << 24)) & _M
    if rem >= 3:  a = (a + (k[2] << 16)) & _M
    if rem >= 2:  a = (a + (k[1] << 8)) & _M
    if rem >= 1:  a = (a + k[0]) & _M
    a, b, c = _mix(a, b, c)
    return c
