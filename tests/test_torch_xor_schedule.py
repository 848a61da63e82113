"""The port's XOR-schedule compiler and scheduled engine held against ceph_tpu.

Same seeded numpy inputs through both packages, every comparison exact: the
compiler must give the reference's op stream for the same matrix bytes,
``apply_bits_plain`` must equal the reference's Pallas kernel (interpret
mode) and jitted XLA twin, and the cost model must decide as the reference
does on the CPU.  Kernel K3 itself runs only on the card (chip_smoke.py);
its generated source is also compiled here with the host C++ compiler,
which runs the same arithmetic thread by thread.
"""

import ctypes
import json
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.ops.gf2kernels as ref_k
import ceph_tpu.ops.xor_schedule as ref_xs
from ceph_tpu.ec import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.tools import ec_autotune as ref_autotune
import ceph_tpu_torch.ops.gf2kernels as gk
import ceph_tpu_torch.ops.xor_schedule as xs
from ceph_tpu_torch.gf import build_decode_matrix, gen_cauchy1_matrix, \
    gen_rs_matrix, gf_matmul
from ceph_tpu_torch.ops import _build, xor_sched_codegen
from ceph_tpu_torch.tools import ec_autotune


# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

RS83 = gen_rs_matrix(11, 8)
# a unit row (bit-matrix rows that copy input planes), a zero row (output
# -1) and a repeated row (one value serving two outputs)
SPECIAL = np.array([[1, 0, 0, 0], [0, 0, 0, 0], [5, 7, 0, 2], [5, 7, 0, 2],
                    [0, 0, 1, 0]], np.uint8)


def _ref_codec(plugin, **profile):
    return RefRegistry().factory(plugin, {k: str(v) for k, v in
                                          profile.items()})


def _gf_matrices():
    """(label, GF(2^8) coefficient matrix) on the recovery-code path."""
    lrc = _ref_codec("lrc", k=8, m=4, l=3)
    pmsr = _ref_codec("pmsr", k=3, m=2)
    return [
        ("rs8/3 parity", RS83[8:]),
        ("rs8/3 decode[1,9]", build_decode_matrix(RS83, 8, [1, 9])[0]),
        ("cauchy10/4 parity", gen_cauchy1_matrix(14, 10)[10:]),
        ("lrc8/4/3 parity", lrc.parity_matrix),
        ("lrc8/4/3 local repair", lrc.repair_matrix((1, 2, 3), (0,))),
        ("pmsr3/2 parity", pmsr.parity_matrix),
        ("pmsr3/2 aggregate", pmsr.aggregate_matrix(0, (1, 2, 3, 4))),
        ("unit, zero and repeated rows", SPECIAL),
    ]


GF_MATRICES = _gf_matrices()
GF_IDS = [label for label, _ in GF_MATRICES]


def _data(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _oracle(mat, data):
    return np.stack([gf_matmul(mat, d) for d in data])


def _same_schedule(a, b):
    assert (a.digest, a.n_in, a.n_out, a.ops, a.outputs, a.naive_terms,
            a.peak_registers, a.max_registers) == \
        (b.digest, b.n_in, b.n_out, b.ops, b.outputs, b.naive_terms,
         b.peak_registers, b.max_registers)


# -- the compiler -------------------------------------------------------------

def _random_bitmatrices():
    out = []
    for seed, (r, c), p in [(0, (24, 64), 0.5), (1, (16, 40), 0.2),
                            (2, (40, 24), 0.7), (3, (8, 128), 0.05)]:
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}", (rng.random((r, c)) < p)
                    .astype(np.uint8)))
    zc = np.zeros((4, 16), np.uint8)
    zc[1, 3] = 1                           # copy row
    zc[2, [3, 7, 9]] = 1
    zc[3] = zc[2]                          # duplicate
    out.append(("zero/copy/duplicate rows", zc))
    return out + [(label, ref_k.bitmatrix_i8(m)) for label, m in GF_MATRICES]


BITMATRICES = _random_bitmatrices()


@pytest.mark.parametrize("max_registers", [xs.DEFAULT_MAX_REGISTERS, 8])
@pytest.mark.parametrize("label,bm", BITMATRICES,
                         ids=[label for label, _ in BITMATRICES])
def test_compile_schedule_matches_reference(label, bm, max_registers):
    port = xs.compile_schedule(bm, max_registers=max_registers)
    ref = ref_xs.compile_schedule(bm, max_registers=max_registers)
    _same_schedule(port, ref)
    assert port.peak_registers <= max_registers
    assert xs.matrix_digest(bm) == ref_xs.matrix_digest(bm)
    assert xs.naive_xor_terms(bm) == ref_xs.naive_xor_terms(bm)
    planes = _data(4, bm.shape[1], 65)
    assert np.array_equal(xs.apply_host(port, planes),
                          ref_xs.apply_host(ref, planes))


def test_bitmatrix_matches_reference_and_cache_is_process_wide():
    for _, mat in GF_MATRICES:
        assert np.array_equal(gk.bitmatrix_i8(mat), ref_k.bitmatrix_i8(mat))
    bm = gk.bitmatrix_i8(GF_MATRICES[3][1])
    a = xs.schedule_for(bm)
    assert xs.cached_schedule(bm) is a and xs.registered(a.digest) is a
    assert xs.schedule_for(bm.copy()) is a


# -- the plain version against the reference's executors ---------------------

@pytest.mark.parametrize("mat,b,k,l,tile", [
    (RS83[8:], 2, 8, 512, 256),
    (SPECIAL, 3, 4, 256, 128),
], ids=["rs8/3", "unit-zero-repeated"])
def test_apply_bits_plain_matches_reference_pallas_interpret(
        monkeypatch, mat, b, k, l, tile):
    monkeypatch.setenv("CEPH_TPU_PALLAS_INTERPRET", "1")
    bm = gk.bitmatrix_i8(mat)
    ref_sched = ref_xs.schedule_for(bm)      # registers it for the kernel
    ref_xs._compiled_sched_pallas.cache_clear()
    data = _data(5, b, k, l)
    fn = ref_xs._compiled_sched_pallas(ref_sched.digest, b, k, l, tile)
    want = np.asarray(fn(jnp.asarray(data)))
    got = xs.apply_bits_plain(xs.schedule_for(bm), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, _oracle(mat, data))


@pytest.mark.parametrize("label,mat", GF_MATRICES, ids=GF_IDS)
def test_apply_bits_plain_matches_reference_xla_ragged(label, mat):
    k = mat.shape[1]
    bm = gk.bitmatrix_i8(mat)
    b, l = 3, 1001
    data = _data(6, b, k, l)
    ref_sched = ref_xs.schedule_for(bm)
    want = np.asarray(ref_xs._compiled_sched_batch(
        ref_sched.digest, b, k, l)(jnp.asarray(data)))
    got = xs.apply_bits_plain(xs.schedule_for(bm), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, _oracle(mat, data))


# -- K3's generated source ----------------------------------------------------

def _host_k3(sched, tmp_path):
    """K3's generated source built with the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K3's source for the CPU")
    name = xor_sched_codegen.entry_name(sched)
    src = tmp_path / f"{name}.cpp"
    src.write_text(xor_sched_codegen.generate(sched))
    lib = tmp_path / f"lib{name}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=120)
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return fn


@pytest.mark.parametrize("label,mat", GF_MATRICES, ids=GF_IDS)
def test_k3_source_on_the_host_matches_plain_and_oracle(tmp_path, label, mat):
    sched = xs.schedule_for(gk.bitmatrix_i8(mat))
    fn = _host_k3(sched, tmp_path)
    r, k = mat.shape
    # 16-byte rows take the vector path, the others the byte path; 48 and
    # 1001 leave a ragged last column group
    for b, l in [(2, 512), (3, 48), (5, 1001), (1, 7)]:
        x = torch.from_numpy(_data(7, b, k, l))
        out = torch.full((b, r, l), 0xAB, dtype=torch.uint8)
        assert fn(x.data_ptr(), out.data_ptr(), b, k, r, l, 0, None) == 0
        want = _oracle(mat, x.numpy())
        assert np.array_equal(out.numpy(), want), (b, l)
        assert np.array_equal(xs.apply_bits_plain(sched, x).numpy(), want)
    bad = torch.empty((1, r, 64), dtype=torch.uint8)
    assert fn(x.data_ptr(), bad.data_ptr(), 1, k + 1, r, 64, 0, None) != 0


def test_k3_source_stores_each_row_once_after_its_planes():
    sched = xs.schedule_for(gk.bitmatrix_i8(GF_MATRICES[3][1]))
    lines = xor_sched_codegen.generate(sched).splitlines()
    defined = {}
    for n, line in enumerate(lines):
        for v in re.findall(r"\b(v\d+) = ", line):
            defined[v] = n
    stores = {}
    for n, line in enumerate(lines):
        hit = re.search(r"io\.store\((\d+), o\)", line)
        if hit:
            assert hit.group(1) not in stores
            stores[hit.group(1)] = n
            for v in re.findall(r"\bv\d+\b", line):
                assert defined[v] < n
    assert sorted(map(int, stores)) == list(range(sched.n_out // 8))
    assert len(defined) == sched.n_terms
    assert f"XOR_SCHED_ENTRY(xor_sched_{sched.digest}, Body)" in lines


# -- the cost model and the routing hook ---------------------------------------

@pytest.fixture
def tuned_table(tmp_path, monkeypatch):
    """Point both packages at one tuned table; returns a writer."""
    path = tmp_path / "gf2_tuned.json"
    monkeypatch.setattr(ref_k, "_TUNED_PATH", str(path))
    monkeypatch.setattr(gk, "_TUNED_PATH", str(path))

    def write(table):
        path.write_text(json.dumps(table))
        ref_k._tuned_cfgs.cache_clear()
        gk._tuned_cfgs.cache_clear()
    write({})
    yield write
    ref_k._tuned_cfgs.cache_clear()
    gk._tuned_cfgs.cache_clear()


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_want_scheduled_decides_as_the_reference(monkeypatch, tuned_table,
                                                 env):
    pmsr54 = _ref_codec("pmsr", k=5, m=4).parity_matrix
    cases = [(mat, 4096) for _, mat in GF_MATRICES]
    if env != "1":       # a forced compile of this one is ~15 s per package
        cases.append((pmsr54, 32768))
    tables = [{}, {"xor_sched": {"8,3": "dense", "8,8,4096": "scheduled",
                                 "3,1": {"engine": "dense"},
                                 "4,5": {"engine": "scheduled"}}}]
    if env is None:
        monkeypatch.delenv("CEPH_TPU_XOR_SCHED", raising=False)
    else:
        monkeypatch.setenv("CEPH_TPU_XOR_SCHED", env)
    picked = 0
    for table in tables:
        tuned_table(table)
        for mat, lane in cases:
            bm = gk.bitmatrix_i8(mat)
            for backend, ref_backend in [("cpu", "cpu"), ("cuda", "tpu")]:
                got = xs.want_scheduled(bm, lane, backend)
                want = ref_xs.want_scheduled(bm, lane, ref_backend)
                assert (got is None) == (want is None), (mat.shape, backend)
                if got is not None:
                    _same_schedule(got, want)
                    picked += 1
    assert picked if env != "0" else not picked


def test_card_routes_dense_without_override_or_tuned_entry(monkeypatch,
                                                           tuned_table):
    monkeypatch.delenv("CEPH_TPU_XOR_SCHED", raising=False)
    for _, mat in GF_MATRICES:
        assert xs.want_scheduled(gk.bitmatrix_i8(mat), 131072, "cuda") is None


def test_cpu_tensor_routes_through_the_scheduled_engine(monkeypatch,
                                                        tuned_table):
    monkeypatch.setenv("CEPH_TPU_XOR_SCHED", "1")
    dense = []
    for name in ("gf2_matmul_popc", "gf2_matmul_mma"):
        monkeypatch.setattr(gk, name, lambda *a, _n=name, **kw:
                            dense.append(_n))
    mat = GF_MATRICES[4][1]                    # LRC local repair, (1, 3)
    data = _data(8, 6, 3, 256)
    before, launches = xs.STATS.snapshot(), dict(gk.LAUNCHES)
    out = gk.gf_matmul_batch_device(mat, torch.from_numpy(data))
    after = xs.STATS.snapshot()
    assert np.array_equal(out.numpy(), _oracle(mat, data))
    sched = xs.schedule_for(gk.bitmatrix_i8(mat))
    assert after[0] == before[0] + 1
    assert after[2] == before[2] + sched.terms_saved
    assert after[1] == 0 and not dense and gk.LAUNCHES == launches
    # the CPU heuristic picks the same engine as the reference's
    monkeypatch.delenv("CEPH_TPU_XOR_SCHED")
    cauchy = gen_cauchy1_matrix(11, 8)[8:]
    assert ref_xs.want_scheduled(ref_k.bitmatrix_i8(cauchy), 256, "cpu")
    data = _data(9, 4, 8, 256)
    assert np.array_equal(gk.gf_matmul_batch_device(cauchy, data,
                                                    out_np=True,
                                                    device="cpu"),
                          _oracle(cauchy, data))
    assert xs.STATS.snapshot()[0] == after[0] + 1 and not dense


def test_first_use_check_raises_on_a_wrong_output(monkeypatch):
    monkeypatch.setattr(xs, "_checked", set())
    plain = xs.apply_bits_plain
    monkeypatch.setattr(xs, "apply_bits_plain",
                        lambda sched, x: plain(sched, x) ^ 1)
    mat = GF_MATRICES[5][1]
    sched = xs.schedule_for(gk.bitmatrix_i8(mat))
    x = torch.from_numpy(_data(10, 2, mat.shape[1], 64))
    with pytest.raises(RuntimeError, match="host GF"):
        xs.sched_matmul_batch_device(sched, mat, x)
    monkeypatch.setattr(xs, "apply_bits_plain", plain)
    assert np.array_equal(xs.sched_matmul_batch_device(sched, mat, x).numpy(),
                          _oracle(mat, x.numpy()))


def test_k3_wrapper_takes_only_cuda_tensors():
    mat = GF_MATRICES[0][1]
    sched = xs.schedule_for(gk.bitmatrix_i8(mat))
    with pytest.raises(ValueError, match="CUDA"):
        xs.xor_sched(sched, torch.zeros((1, 8, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        xor_sched_codegen.generate(xs.compile_schedule(np.ones((4, 8),
                                                               np.uint8)))


# -- the engine sweep ----------------------------------------------------------

def test_ec_autotune_cpu_smoke_writes_the_reference_keys(tmp_path, capsys):
    args = ["--k", "4", "--m", "2", "--cpu-smoke", "--codes", "lrc,pmsr",
            "--write", "--out"]
    assert ec_autotune.main(args + [str(tmp_path / "port.json")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu"
    assert ref_autotune.main(args + [str(tmp_path / "ref.json")]) == 0
    capsys.readouterr()
    port = json.loads((tmp_path / "port.json").read_text())["xor_sched"]
    ref = json.loads((tmp_path / "ref.json").read_text())["xor_sched"]
    assert sorted(port) == sorted(ref)
    assert {"4,2", "4,2,4096", "8,8", "3,1"} <= set(port)
    for key, rec in port.items():
        assert set(rec) == set(ref[key]), key
        assert rec["engine"] in ("dense", "scheduled")
        for field in ("sched_terms", "naive_terms", "reduction_pct"):
            assert rec[field] == ref[key][field], (key, field)
        if "tag" in rec:
            assert rec["tag"] == ref[key]["tag"]
