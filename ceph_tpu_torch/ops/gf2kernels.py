"""GF(2^8) matrix multiply as a GF(2) bit-matmul on the CUDA card.

An (r,k) GF(2^8) coefficient matrix applied to k data chunks is linear over
GF(2), so the whole stripe encode is

    parity_bits(8r, N) = W(8r, 8k) @ data_bits(8k, N)  (mod 2)

with W the bit-expanded coefficient matrix (``bitmatrix_i8``).  Two hand
written kernels in ``csrc/gf2_matmul.cu`` compute it:

  * ``gf2_matmul_popc`` (K1): AND + popcount on CUDA cores, any shape;
  * ``gf2_matmul_mma`` (K2): g stripes per block on the int8 tensor cores
    with the plane-major, block-diagonal ``w_gN_planemajor``.

Each has a plain PyTorch version (``gf2_matmul_plain``,
``gf2_matmul_grouped_plain``).  A wrapper runs the plain version only for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
``gf_matmul_batch_device`` first asks the XOR-schedule cost model
(``xor_schedule.maybe_batch_scheduled``: kernel K3 when it picks the
scheduled engine), then routes by shape: K2 where the packed kernel's tile
and group rules hold, K1 otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..gf.gf8 import gf_matmul, matrix_to_bitmatrix
from . import _build

# lane tile of the packed kernel's eligibility ladder (_pick_tile)
LANE_TILE = 8192
# byte columns K2 handles per step; every K2 shape has L % MMA_COLS == 0
MMA_COLS = 128

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"gf2_matmul_popc": 0, "gf2_matmul_mma": 0, "xor_sched": 0}

# the tuned table the cost model reads (``tools/ec_autotune.py --write``
# writes it); absent by default, so the card routes dense
_TUNED_PATH = os.path.join(os.path.dirname(__file__), "gf2_tuned.json")


@functools.lru_cache(maxsize=1)
def _tuned_cfgs() -> dict:
    """The tuned table; an absent or unreadable file is an empty one."""
    try:
        with open(_TUNED_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def bucket_batch(b: int) -> int:
    """Round a batch dimension up to a power of two.

    Zero-padding the batch axis to the bucket is byte-exact (stripes are
    independent) and bounds the distinct shapes a coalescing caller makes.
    """
    n = 1
    while n < b:
        n *= 2
    return n


@functools.lru_cache(maxsize=256)
def _bitmatrix_cached(mat_bytes: bytes, r: int, k: int) -> np.ndarray:
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(r, k)
    return matrix_to_bitmatrix(mat).astype(np.int8)


def _as_matrix(matrix) -> np.ndarray:
    return np.ascontiguousarray(matrix, dtype=np.uint8)


def bitmatrix_i8(matrix: np.ndarray) -> np.ndarray:
    """(r,k) GF coefficient matrix -> (8r,8k) int8 GF(2) matrix (cached)."""
    matrix = _as_matrix(matrix)
    return _bitmatrix_cached(matrix.tobytes(), *matrix.shape)


def pick_group(k: int, b: int) -> int:
    """Largest g with contraction 8*k*g <= 128 that divides the batch."""
    g = max(1, 16 // k)
    while g > 1 and (b % g or 8 * k * g > 128):
        g //= 2
    return g


@functools.lru_cache(maxsize=64)
def _w_gN_cached(mat_bytes: bytes, r: int, k: int, g: int) -> np.ndarray:
    w = _bitmatrix_cached(mat_bytes, r, k)      # (8r, 8k), col 8j+s
    r8, gk = 8 * r, g * k
    out = np.zeros((g * r8, 8 * gk), np.int8)
    for s in range(8):
        for j in range(gk):
            stripe, jj = divmod(j, k)
            out[stripe * r8:(stripe + 1) * r8, s * gk + j] = w[:, 8 * jj + s]
    return out


def w_gN_planemajor(matrix: np.ndarray, g: int) -> np.ndarray:
    """(g*8r, 8*g*k) block-diagonal-by-stripe W whose columns follow the
    plane-major unpack of g stripes' chunks: column s*(g*k) + j is bit s of
    chunk j (stripe j // k)."""
    matrix = _as_matrix(matrix)
    return _w_gN_cached(matrix.tobytes(), *matrix.shape, g)


def _pick_tile(l: int, want: int = LANE_TILE) -> int:
    """Lane-tile ladder of the packed kernel; 0 = ineligible."""
    if l % want == 0:
        return want
    if l % LANE_TILE == 0:
        return LANE_TILE
    if l <= LANE_TILE and l % 128 == 0:
        return l
    return 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  Products of 0/1 values with a contraction of at
# most 256 are exact in float32, so they agree with the kernels byte for byte.
# ---------------------------------------------------------------------------

def _pack_bits(acc: torch.Tensor) -> torch.Tensor:
    """(..., 8r, L) bit counts -> (..., r, L) uint8: byte i = sum_t (row 8i+t & 1) << t."""
    *lead, r8, l = acc.shape
    bits = (acc.to(torch.int32) & 1).reshape(*lead, r8 // 8, 8, l)
    shifts = torch.arange(8, dtype=torch.int32, device=acc.device).view(8, 1)
    return (bits << shifts).sum(dim=-2).to(torch.uint8)


def gf2_matmul_plain(w: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8r,8k) 0/1 W x (B,k,L) uint8 -> (B,r,L) uint8.

    Unpack to bit planes (row 8j+s = bit s of chunk j), matmul, &1, pack.
    """
    b, k, l = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device).view(1, 1, 8, 1)
    bits = ((data.unsqueeze(2) >> shifts) & 1).reshape(b, 8 * k, l)
    acc = torch.matmul(w.to(device=data.device, dtype=torch.float32),
                       bits.to(torch.float32))
    return _pack_bits(acc)


def gf2_matmul_grouped_plain(w_gN: torch.Tensor, data: torch.Tensor,
                             g: int) -> torch.Tensor:
    """(g*8r, 8gk) block-diagonal W x (B,k,L) uint8 -> (B,r,L) uint8.

    g stripes at a time, unpacked plane-major (row s*g*k + j = bit s of
    chunk j of the group), the layout K2 multiplies.
    """
    b, k, l = data.shape
    x = data.reshape(b // g, 1, g * k, l)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device).view(1, 8, 1, 1)
    bits = ((x >> shifts) & 1).reshape(b // g, 8 * g * k, l)
    acc = torch.matmul(w_gN.to(device=data.device, dtype=torch.float32),
                       bits.to(torch.float32))
    return _pack_bits(acc).reshape(b, -1, l)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.library("gf2_matmul")
    lib.gf2_matmul_popc.argtypes = [_VP, _VP, _VP, _I, _I, _I, _LL, _I, _VP]
    lib.gf2_matmul_popc.restype = _I
    lib.gf2_matmul_mma.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _LL, _I, _VP]
    lib.gf2_matmul_mma.restype = _I
    return lib


def _check_data(data: torch.Tensor, k: int) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(data).__name__}")
    if data.dtype != torch.uint8 or data.dim() != 3 or data.shape[1] != k:
        raise ValueError(
            f"expected (B, {k}, L) uint8 data, got {tuple(data.shape)} "
            f"{data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def _launch(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> ctypes.c_void_p:
    return _VP(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=256)
def _w_popc_device(mat_bytes: bytes, r: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """W rows packed for K1: (8r, ceil(k/4)) 32-bit words, word q = bits 32q.."""
    nq = (k + 3) // 4
    w = np.zeros((8 * r, 32 * nq), np.uint8)
    w[:, :8 * k] = _bitmatrix_cached(mat_bytes, r, k)
    words = np.packbits(w.reshape(8 * r, nq, 32), axis=-1, bitorder="little")
    return torch.from_numpy(
        np.ascontiguousarray(words).view("<i4").reshape(8 * r, nq)).to(device)


@functools.lru_cache(maxsize=256)
def _w_mma_device(mat_bytes: bytes, r: int, k: int, g: int,
                  device: torch.device) -> torch.Tensor:
    """W_gN for K2, zero-padded to 16-multiples and tile-major (MT,KT,16,16)."""
    mt, kt = (g * r + 1) // 2, (g * k + 1) // 2
    w = np.zeros((16 * mt, 16 * kt), np.int8)
    w[:8 * g * r, :8 * g * k] = _w_gN_cached(mat_bytes, r, k, g)
    tiles = w.reshape(mt, 16, kt, 16).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(tiles)).to(device)


def gf2_matmul_popc(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """K1: (r,k) GF(2^8) matrix x (B,k,L) uint8 -> (B,r,L) uint8, any L, k <= 32."""
    matrix = _as_matrix(matrix)
    r, k = matrix.shape
    _check_data(data, k)
    if data.device.type == "cpu":
        return gf2_matmul_plain(torch.from_numpy(bitmatrix_i8(matrix)), data)
    b, _, l = data.shape
    if k > 32 or b > 65535:
        raise ValueError(f"gf2_matmul_popc takes k <= 32 and B <= 65535, "
                         f"got k={k} B={b}")
    w = _w_popc_device(matrix.tobytes(), r, k, data.device)
    out = torch.empty((b, r, l), dtype=torch.uint8, device=data.device)
    _launch("gf2_matmul_popc", w.data_ptr(), data.data_ptr(), out.data_ptr(),
            b, k, r, l, data.device.index, _stream(data.device))
    return out


def gf2_matmul_mma(matrix: np.ndarray, data: torch.Tensor,
                   g: int) -> torch.Tensor:
    """K2: (r,k) GF(2^8) matrix x (B,k,L) uint8 -> (B,r,L) uint8, g stripes
    per block; needs B % g == 0, 8*g*k <= 128 and L % 128 == 0."""
    matrix = _as_matrix(matrix)
    r, k = matrix.shape
    _check_data(data, k)
    b, _, l = data.shape
    if b % g or 8 * g * k > 128 or l % MMA_COLS:
        raise ValueError(f"gf2_matmul_mma takes B % g == 0, 8*g*k <= 128 and "
                         f"L % {MMA_COLS} == 0, got B={b} g={g} k={k} L={l}")
    if data.device.type == "cpu":
        return gf2_matmul_grouped_plain(
            torch.from_numpy(w_gN_planemajor(matrix, g)), data, g)
    if b // g > 65535 or data.data_ptr() % 16:
        raise ValueError("gf2_matmul_mma takes B/g <= 65535 and 16-byte "
                         "aligned data")
    w = _w_mma_device(matrix.tobytes(), r, k, g, data.device)
    out = torch.empty((b, r, l), dtype=torch.uint8, device=data.device)
    _launch("gf2_matmul_mma", w.data_ptr(), data.data_ptr(), out.data_ptr(),
            b, k, r, g, l, data.device.index, _stream(data.device))
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

# (kernel, matrix, g) combinations whose first output matched the host oracle
_checked: set[tuple] = set()


def _first_use_check(name: str, matrix: np.ndarray, g: int,
                     x: torch.Tensor, out: torch.Tensor) -> None:
    """Hold a kernel's first output for a matrix against the host oracle on a
    small slice; a mismatch raises (a wrong kernel must never serve)."""
    key = (name, matrix.tobytes(), matrix.shape, g)
    if out.device.type == "cpu" or key in _checked:
        return
    n, nb = min(256, x.shape[2]), min(2, x.shape[0])
    got = out[:nb, :, :n].cpu().numpy()
    sample = x[:nb, :, :n].cpu().numpy()
    for i in range(nb):
        if not np.array_equal(got[i], gf_matmul(matrix, sample[i])):
            raise RuntimeError(
                f"{name}: output differs from the host GF(2^8) oracle")
    _checked.add(key)


def _to_device(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        dev = data.device if device is None else resolve_device(device)
        return data.to(device=dev, dtype=torch.uint8).contiguous()
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))


def gf_matmul_batch_device(matrix: np.ndarray, data, *, out_np: bool = False,
                           device=None):
    """Batched stripes: (B, k, L) -> (B, r, L), one kernel launch.

    ``data`` is a numpy array or a tensor; it runs on ``device`` (default:
    the tensor's own device, else CUDA).  The scheduled engine (K3) serves
    when the cost model picks it; otherwise K2 serves when L passes
    ``_pick_tile`` and the group contraction 8*k*g fits 128, K1 otherwise.
    The result stays a tensor on the device unless ``out_np``.
    """
    from .xor_schedule import maybe_batch_scheduled
    matrix = _as_matrix(matrix)
    x = _to_device(data, device)
    b, k, l = x.shape
    out = maybe_batch_scheduled(matrix, x)
    if out is None:
        g = pick_group(k, b)
        if _pick_tile(l) and 8 * k * g <= 128:
            out = gf2_matmul_mma(matrix, x, g)
            _first_use_check("gf2_matmul_mma", matrix, g, x, out)
        else:
            out = gf2_matmul_popc(matrix, x)
            _first_use_check("gf2_matmul_popc", matrix, 1, x, out)
    return out.cpu().numpy() if out_np else out


def gf_matmul_device(matrix: np.ndarray, data, *, out_np: bool = True,
                     device=None):
    """(r,k) GF(2^8) matrix x (k,N) bytes -> (r,N) bytes: K1 on a (1,k,N) view."""
    matrix = _as_matrix(matrix)
    x = _to_device(data, device)
    out = gf2_matmul_popc(matrix, x.unsqueeze(0))[0]
    _first_use_check("gf2_matmul_popc", matrix, 1, x.unsqueeze(0),
                     out.unsqueeze(0))
    return out.cpu().numpy() if out_np else out
