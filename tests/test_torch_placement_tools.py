"""The port's placement tools against ceph_tpu's, on the CPU: ``crushtool``
(compile, decompile, ``--test``), ``osdmaptool`` (``--print``,
``--test-map-pgs``, ``--upmap``) and the upmap balancer (``full_mapping``,
``compute_upmaps``, ``pg_distribution``, ``compact_items``).

The same inputs go through both; the outputs must be byte-identical (the
tools') or equal (the balancer's plans and summaries).  The port builds its
table with ``--device cpu``, through the scalar sweep below
``FUSED_MIN_LANES`` and, with the threshold at 1, through the bulk mapper
(K5's plain version); the reference's table comes from its scalar sweep.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ceph_tpu.crush.builder import build_hierarchy
from ceph_tpu.mgr import balancer as ref_balancer
from ceph_tpu.mon.osdmap import crush_to_dict as ref_crush_to_dict
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.crush import state
from ceph_tpu_torch.mgr import balancer
from ceph_tpu_torch.mon import pg_mapping as pm_mod
from ceph_tpu_torch.tools import crushtool, osdmaptool
from test_crushtool import MAP_TEXT
from test_torch_osdmap import make_ref_map, port_of

ROOT = Path(__file__).resolve().parent.parent


def run_main(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def run_port_cli(module: str, *argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def bulk_route(monkeypatch):
    """The port's table through the bulk mapper at any lane count."""
    monkeypatch.setattr(pm_mod, "FUSED_MIN_LANES", 1)


# -- crushtool --------------------------------------------------------------

@pytest.fixture
def map_files(tmp_path):
    text = tmp_path / "map.txt"
    text.write_text(MAP_TEXT)
    blob = tmp_path / "map.json"
    blob.write_text(json.dumps(ref_crush_to_dict(build_hierarchy([3, 4, 5])),
                               indent=1))
    return {"text": str(text), "json": str(blob)}


@pytest.mark.parametrize("kind", ["text", "json"])
def test_compile_and_decompile_match_reference(map_files, tmp_path, kind):
    src = map_files[kind]
    for flag in ("-c", "-d"):
        outs = []
        for i, main in enumerate((ref_crushtool.main, crushtool.main)):
            path = tmp_path / f"{flag}{i}"
            assert run_main(main, [flag, src, "-o", str(path)])[0] == 0
            outs.append(path.read_bytes())
            outs.append(run_main(main, [flag, src])[1])
        assert outs[0] == outs[2] and outs[1] == outs[3], flag


def test_builder_map_decompiles_as_the_reference_does():
    ref_map = build_hierarchy([2, 3, 4])
    port_map = state.crush_map_from_dict(ref_crush_to_dict(ref_map))
    assert crushtool.decompile(port_map) == ref_crushtool.decompile(ref_map)
    cm, names, devices = crushtool.compile_text(MAP_TEXT)
    ref_cm, ref_names, ref_devices = ref_crushtool.compile_text(MAP_TEXT)
    assert state.crush_to_dict(cm) == ref_crush_to_dict(ref_cm)
    assert (names, devices) == (ref_names, ref_devices)


@pytest.mark.parametrize("bad", [
    "bogus line here", "type 1 host\nhost h {\n  alg straw2\n}\n",
    "tunable nope 1", "rule r {\n id 0\n step take nowhere\n}\n"])
def test_compile_errors_match_reference(bad):
    with pytest.raises(ref_crushtool.CompileError) as want:
        ref_crushtool.compile_text(bad)
    with pytest.raises(crushtool.CompileError) as got:
        crushtool.compile_text(bad)
    assert str(got.value) == str(want.value)


RUN_TEST_CASES = {   # run_test's (rule, numrep, min_x, max_x, weights, util)
    "firstn": (0, 2, 0, 255, {}, True),
    "indep": (1, 3, 100, 400, {}, False),
    "weights": (0, 3, 0, 300, {0: 0.0, 3: 0.5}, True),
    "indep weights": (1, 2, 0, 200, {2: 0.0}, True),
    "no rule": (7, 2, 0, 20, {}, False),
}


@pytest.mark.parametrize("route", ["scalar", "bulk"])
@pytest.mark.parametrize("case", sorted(RUN_TEST_CASES))
def test_run_test_output_matches_reference(request, case, route):
    if route == "bulk":
        request.getfixturevalue("bulk_route")
    cm, _, _ = crushtool.compile_text(MAP_TEXT)
    ref_cm, _, _ = ref_crushtool.compile_text(MAP_TEXT)
    outs = [io.StringIO(), io.StringIO()]
    want = ref_crushtool.run_test(ref_cm, *RUN_TEST_CASES[case], out=outs[0])
    got = crushtool.run_test(cm, *RUN_TEST_CASES[case], out=outs[1],
                             device="cpu")
    assert got == want
    assert outs[1].getvalue() == outs[0].getvalue()
    assert "result size" in outs[1].getvalue()


def test_crushtool_cli(map_files):
    argv = ["--test", "-i", map_files["text"], "--rule", "1", "--num-rep",
            "3", "--max-x", "63", "--show-utilization"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    want = subprocess.run([sys.executable, "-m", "ceph_tpu.tools.crushtool",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    got = run_port_cli("ceph_tpu_torch.tools.crushtool", *argv,
                       "--device", "cpu")
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert "CRUSH rule 1 x 63" in got.stdout


# -- osdmaptool -------------------------------------------------------------

@pytest.fixture(scope="module")
def osdmap_file(tmp_path_factory):
    ref = make_ref_map(31, [3, 3, 4], pg_num=64, extra_pool=True)
    path = tmp_path_factory.mktemp("osdmap") / "map.json"
    path.write_text(json.dumps(ref.to_dict()))
    return str(path)


OSDMAPTOOL_ARGS = {
    "print": ["--print"],
    "default": [],
    "test-map-pgs": ["--test-map-pgs"],
    "pool": ["--test-map-pgs", "--pool", "2"],
    "upmap": ["--upmap", "-", "--upmap-max", "25"],
    "all": ["--print", "--test-map-pgs", "--upmap", "-"],
}


@pytest.mark.parametrize("route", ["scalar", "bulk"])
@pytest.mark.parametrize("case", sorted(OSDMAPTOOL_ARGS))
def test_osdmaptool_output_matches_reference(osdmap_file, request, case,
                                             route):
    if route == "bulk":
        request.getfixturevalue("bulk_route")
    argv = [osdmap_file, *OSDMAPTOOL_ARGS[case]]
    want = run_main(ref_osdmaptool.main, argv)
    assert run_main(osdmaptool.main, argv + ["--device", "cpu"]) == want


def test_osdmaptool_upmap_file(osdmap_file, tmp_path):
    paths = [tmp_path / "ref.txt", tmp_path / "port.txt"]
    run_main(ref_osdmaptool.main, [osdmap_file, "--upmap", str(paths[0])])
    run_main(osdmaptool.main, [osdmap_file, "--upmap", str(paths[1]),
                               "--device", "cpu"])
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_text().startswith("ceph osd pg-upmap-items ")


def test_osdmaptool_builds_on_the_card_by_default(osdmap_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_main(osdmaptool.main, [osdmap_file, "--print"]) == \
        run_main(ref_osdmaptool.main, [osdmap_file, "--print"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_main(osdmaptool.main, [osdmap_file, "--test-map-pgs"])


def test_osdmaptool_cli(osdmap_file):
    proc = run_port_cli("ceph_tpu_torch.tools.osdmaptool", osdmap_file,
                        "--test-map-pgs", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == run_main(ref_osdmaptool.main,
                                   [osdmap_file, "--test-map-pgs"])[1]


# -- the balancer -----------------------------------------------------------

@pytest.fixture(scope="module")
def maps():
    ref = make_ref_map(33, [2, 3, 2, 3], pg_num=48)
    return ref, port_of(ref)


def test_full_mapping_and_distribution_match_reference(maps):
    ref, m = maps
    assert balancer.full_mapping(m) == ref_balancer.full_mapping(ref)
    assert balancer.pg_distribution(m) == ref_balancer.pg_distribution(ref)


@pytest.mark.parametrize("max_moves", [1, 10, 60])
def test_balance_matches_reference(maps, max_moves):
    ref, m = maps
    assert balancer.balance(m, max_moves) == \
        ref_balancer.balance(ref, max_moves)
    assert balancer.compute_upmaps(m, max_moves) == \
        ref_balancer.compute_upmaps(ref, max_moves)


def test_compact_items_matches_reference():
    chains = [([], [[1, 2]]), ([[1, 2]], [[2, 3]]), ([[1, 2]], [[2, 1]]),
              ([[4, 5], [6, 7]], [[7, 8], [5, 4]]), ([[1, 1]], [[3, 3]])]
    for existing, new in chains:
        assert balancer.compact_items(existing, new) == \
            ref_balancer.compact_items(existing, new)
