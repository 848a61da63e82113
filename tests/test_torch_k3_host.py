"""K3's tiled design, built with the host C++ compiler and held against ceph_tpu.

``csrc/xor_sched.cuh`` compiles as host C++ (no ``__CUDACC__``), where the
entry runs every thread in a loop.  The generated sources of large-k
schedules (8k = 160 input planes: RS k=20,m=4 parity and a PMSR k=5,m=4
decode) and of a tall matrix (160 output planes: two tiles) are held byte
for byte against ``apply_bits_plain``, the host oracle ``gf_matmul`` and the
reference's ``apply_host``; the design choice ``design_for`` and its tile
plan are pure functions, checked here.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ceph_tpu.ops.xor_schedule as ref_xs
from ceph_tpu.ec import ErasureCodePluginRegistry as RefRegistry
import ceph_tpu_torch.ops.gf2kernels as gk
import ceph_tpu_torch.ops.xor_schedule as xs
from ceph_tpu_torch.gf import gen_rs_matrix, gf_matmul
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import xor_sched_codegen as cg

torch.set_num_threads(1)


def _pmsr54_decode():
    """The PMSR k=5,m=4 repair matrix of erasures [1, 6], from the reference
    codec: (8, 20) sub-chunk rows, 160 input planes."""
    codec = RefRegistry().factory("pmsr", {"k": "5", "m": "4"})
    n = codec.get_chunk_count()
    return codec.repair_matrix(*codec.decode_plan({1, 6},
                                                  set(range(n)) - {1, 6}))


LARGE = {"rs20/4 parity": lambda: gen_rs_matrix(24, 20)[20:],
         "pmsr5/4 decode[1,6]": _pmsr54_decode,
         "tall 20x8": lambda: gen_rs_matrix(28, 8)[8:]}


@functools.lru_cache(maxsize=None)
def _large(label):
    mat = np.ascontiguousarray(LARGE[label](), np.uint8)
    return mat, xs.schedule_for(gk.bitmatrix_i8(mat))


def _designs(sched):
    """The default design and two variants with more tiles, each tile
    fetching the input rows again: tiles of two rows, and of one."""
    return {"default": cg.design_for(sched),
            "tiles of 2 rows": cg.design_for(sched, kind="tiled",
                                             tile_planes=16),
            "tiles of 1 row": cg.design_for(sched, kind="tiled",
                                            tile_planes=8)}


def _host_k3(sched, design, tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K3's source for the CPU")
    name = cg.source_name(sched, design)
    src = tmp_path / f"{name}.cpp"
    src.write_text(cg.generate(sched, design))
    lib = tmp_path / f"lib{name}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=300)
    fn = getattr(ctypes.CDLL(str(lib)), cg.entry_name(sched))
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return fn


# (B, L, misaligned base): 16-byte rows take the vector path; 48 and 1001
# leave a ragged last column group; 7 and a misaligned base take the byte
# path; 5 x 45 groups leave a partial last block of 64 threads
CASES = [(2, 512, False), (3, 48, False), (5, 1001, False), (1, 7, False),
         (5, 32 * 45, False), (2, 256, True)]


@pytest.mark.parametrize("which", ["default", "tiles of 2 rows",
                                   "tiles of 1 row"])
@pytest.mark.parametrize("label", sorted(LARGE))
def test_tiled_source_on_the_host_matches_plain_and_oracle(tmp_path, label,
                                                           which):
    mat, sched = _large(label)
    design = _designs(sched)[which]
    assert design.kind == "tiled"
    fn = _host_k3(sched, design, tmp_path)
    r, k = mat.shape
    rng = np.random.default_rng(11)
    for b, l, misaligned in CASES:
        host = rng.integers(0, 256, (b, k, l), dtype=np.uint8)
        buf = torch.empty(b * k * l + 1, dtype=torch.uint8)
        x = buf[int(misaligned):][:b * k * l].view(b, k, l)
        x.copy_(torch.from_numpy(host))
        out = torch.full((b, r, l), 0xAB, dtype=torch.uint8)
        assert fn(x.data_ptr(), out.data_ptr(), b, k, r, l, 0, None) == 0
        want = np.stack([gf_matmul(mat, host[i]) for i in range(b)])
        assert np.array_equal(out.numpy(), want), (b, l, misaligned)
        assert np.array_equal(xs.apply_bits_plain(sched, x).numpy(), want)
    bad = torch.empty((1, r, 64), dtype=torch.uint8)
    assert fn(x.data_ptr(), bad.data_ptr(), 1, k + 1, r, 64, 0, None) != 0


@pytest.mark.parametrize("label", sorted(LARGE))
def test_plane_rows_are_the_bit_matrix_and_match_the_reference(label):
    """The rows the tiled design evaluates are the bit-matrix's: the
    schedule's ops expanded, as the reference's host executor computes."""
    mat, sched = _large(label)
    bm = gk.bitmatrix_i8(mat)
    rows = cg.plane_rows(sched)
    want = [int("".join(map(str, row[::-1])), 2) for row in bm]
    assert rows == want
    planes = np.random.default_rng(12).integers(0, 256, (sched.n_in, 33),
                                                dtype=np.uint8)
    ref = ref_xs.apply_host(ref_xs.schedule_for(bm), planes)
    for o, row in enumerate(rows):
        acc = np.zeros(33, np.uint8)
        for p in range(sched.n_in):
            if row >> p & 1:
                acc ^= planes[p]
        assert np.array_equal(acc, ref[o]), o


def _fake(n_in, n_out, peak=40):
    return xs.XorSchedule(digest="0" * 16, n_in=n_in, n_out=n_out, ops=(),
                          outputs=(-1,) * n_out, naive_terms=0,
                          peak_registers=peak, max_registers=64)


@pytest.mark.parametrize("n_in,n_out", [(8, 8), (24, 8), (32, 16), (48, 24),
                                        (56, 24), (64, 24), (64, 64),
                                        (72, 8), (160, 32), (160, 64),
                                        (160, 128), (168, 136), (336, 288),
                                        (512, 512), (1024, 256)])
def test_design_for_keeps_every_design_within_the_register_budget(n_in,
                                                                  n_out):
    sched = _fake(n_in, n_out)
    design = cg.design_for(sched)
    assert design.kind == ("register" if n_in <= cg.REGISTER_MAX_IN_PLANES
                           else "tiled")
    assert design.live_estimate(sched) <= cg.REGISTER_BUDGET
    # the launch bounds leave each thread at least the budget (tiled) or
    # ask for nothing (register: one block a SM)
    assert design.kind == "register" and design.min_blocks == 1 or \
        cg.register_cap(design.threads, design.min_blocks) >= \
        cg.REGISTER_BUDGET > \
        cg.register_cap(design.threads, design.min_blocks + 1)
    if design.kind == "tiled":
        rows = [i for tile in design.tiles for i in tile]
        assert rows == list(range(n_out // 8))   # each row once, in order
        assert max(len(t) for t in design.tiles) * 8 <= cg.TILE_MAX_PLANES
        assert len(design.tiles) == -(-n_out // cg.TILE_MAX_PLANES)
    assert cg.design_for(sched) == design           # pure: same shape, same


@pytest.mark.parametrize("n_rows", [1, 3, 8, 16, 17, 36, 64])
@pytest.mark.parametrize("max_rows", [1, 2, 4, 16])
def test_tile_plan_covers_every_row_once_in_even_tiles(n_rows, max_rows):
    tiles = cg.tile_plan(n_rows, max_rows)
    assert [i for t in tiles for i in t] == list(range(n_rows))
    sizes = [len(t) for t in tiles]
    assert max(sizes) <= max_rows and max(sizes) - min(sizes) <= 1
    assert len(tiles) == -(-n_rows // max_rows)


def test_design_for_leaves_the_register_design_past_the_budget():
    """Few input planes but many live temporaries: the tiled design."""
    few = _fake(48, 64, peak=40)
    crowded = _fake(48, 64, peak=cg.REGISTER_BUDGET)
    assert cg.design_for(few).kind == "register"
    assert cg.design_for(crowded).kind == "tiled"
    assert cg.design_for(crowded).live_estimate(crowded) <= cg.REGISTER_BUDGET


def test_design_for_refuses_an_unknown_kind():
    sched = _fake(160, 128)
    with pytest.raises(ValueError, match="unknown"):
        cg.design_for(sched, kind="columns")


def test_generated_text_is_deterministic_per_design():
    """The build cache is keyed by the text: one digest and design give one
    text; another design another text with the same entry."""
    _, sched = _large("rs20/4 parity")
    texts = {which: cg.generate(sched, d) for which, d in
             _designs(sched).items()}
    assert texts["default"] == cg.generate(sched) == \
        cg.generate(xs.compile_schedule(gk.bitmatrix_i8(
            _large("rs20/4 parity")[0])))
    assert len(set(texts.values())) == len(texts)
    for text in texts.values():
        assert f"XOR_SCHED_ENTRY({cg.entry_name(sched)}, Body)" in text
    names = {cg.source_name(sched, d) for d in _designs(sched).values()}
    assert len(names) == len(texts)
    assert cg.source_name(sched) == cg.entry_name(sched)
