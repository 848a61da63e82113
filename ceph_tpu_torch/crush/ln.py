"""Fixed-point 2^44 * log2(x+1) used by straw2 draws.

Tables: RH_LH[2k] ~= 2^48/(1+k/128), RH_LH[2k+1] ~= 2^48*log2(1+k/128),
LL[k] ~= 2^48*log2(1+k/2^15) -- kept as binary data
(crush_ln_tables.npz) because the historical values embed the original
generator's double rounding, which exact arithmetic cannot reproduce and
which placement compatibility requires bit-for-bit (semantics:
src/crush/mapper.c:229-269, tables src/crush/crush_ln_table.h).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_data = np.load(Path(__file__).parent / "crush_ln_tables.npz")
RH_LH_TBL = _data["rh_lh"].astype(np.int64)   # 258 entries
LL_TBL = _data["ll"].astype(np.int64)         # 256 entries

S64_MIN = -(1 << 63)


def crush_ln(xin: int) -> int:
    """2^44 * log2(x+1) for x in [0, 0xffff], as mapper.c:229 computes it."""
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        # clz(x & 0x1FFFF) - 16: normalize so bit 15 is the top set bit
        bits = 16 - (x & 0x1FFFF).bit_length()
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = int(RH_LH_TBL[index1 - 256])
    lh = int(RH_LH_TBL[index1 + 1 - 256])
    xl64 = (x * rh) >> 48
    result = iexpon << 44
    index2 = xl64 & 0xFF
    ll = int(LL_TBL[index2])
    lh = lh + ll
    lh >>= (48 - 12 - 32)
    return result + lh


def _normalize_np(x):
    """Vectorized normalization: returns (x_shifted, iexpon)."""
    x = x.astype(np.int64)
    need = (x & 0x18000) == 0
    masked = x & 0x1FFFF
    # bit_length via log2 on nonzero values (x>=1 always, since x = u+1)
    bl = np.zeros_like(x)
    nz = masked > 0
    bl[nz] = np.floor(np.log2(masked[nz])).astype(np.int64) + 1
    bits = np.where(need, 16 - bl, 0)
    x = x << bits
    iexpon = 15 - bits
    return x, iexpon


def crush_ln_np(xin) -> np.ndarray:
    """Vectorized crush_ln over uint16-ranged inputs."""
    u = np.asarray(xin, dtype=np.int64)
    x = u + 1
    x, iexpon = _normalize_np(x)
    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]
    lh = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * rh) >> 48
    index2 = xl64 & 0xFF
    ll = LL_TBL[index2]
    return (iexpon << 44) + ((lh + ll) >> 4)
