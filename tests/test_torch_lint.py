"""The port's static analyzer (ceph_tpu_torch.analysis) and its front end
(``python -m ceph_tpu_torch.tools.lint``).

* the cases of ``tests/test_lint.py`` on the port's framework: the port's
  tree (``ceph_tpu_torch`` and ``chip_smoke.py``) is clean against the
  port's empty baseline, every rule fires on its bad fixture and stays
  silent on its good one, the suppression layers round-trip, the CLI;
* the thirteen rules the port copies give the reference's findings, on
  the reference's fixtures (read in place) and on ``ceph_tpu/``;
* the adapted rules (device-path-host-sync, torch-global-state,
  kernel-build-once, donated-buffer-aliasing) fire on their torch bad
  fixtures (``tests/torch_lint_fixtures/``) and stay silent on the good
  ones; tracer-safety is recorded as omitted, with its reason.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from ceph_tpu_torch import analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
TREE_PATHS = ["ceph_tpu_torch", "chip_smoke.py"]
BASELINE = os.path.join(REPO, "ceph_tpu_torch", "tools", "lint_baseline.txt")

# the reference's rules the port carries unchanged, on the reference's pairs
COPIED = {
    "await-under-lock": ("osd/await_under_lock_bad.py",
                         "osd/await_under_lock_good.py"),
    "config-schema": ("config_schema_bad.py", "config_schema_good.py"),
    "dropped-task": ("dropped_task_bad.py", "dropped_task_good.py"),
    "hole-sentinel": ("hole_sentinel_bad.py", "hole_sentinel_good.py"),
    "perf-coherence": ("perf_coherence_bad.py", "perf_coherence_good.py"),
    "blocking-under-lock": ("osd/blocking_under_lock_bad.py",
                            "osd/blocking_under_lock_good.py"),
    "denc-symmetry": ("denc_symmetry_bad.py", "denc_symmetry_good.py"),
    "lock-order": ("osd/lock_order_bad.py", "osd/lock_order_good.py"),
    "counter-coverage": ("counter_coverage_bad.py",
                         "counter_coverage_good.py"),
    "hot-path-config-read": ("hot_config_bad.py", "hot_config_good.py"),
    "cross-daemon-state": ("cross_daemon_state_bad.py",
                           "cross_daemon_state_good.py"),
    "wire-safety": ("wire_safety_bad.py", "wire_safety_good.py"),
    "await-invalidates-snapshot": ("osd/await_snapshot_bad.py",
                                   "osd/await_snapshot_good.py"),
}
# the port's torch counterparts, on the torch pairs
ADAPTED = {
    "device-path-host-sync": ("device_path_bad.py", "device_path_good.py"),
    "torch-global-state": ("x64_scope_bad.py", "x64_scope_good.py"),
    "kernel-build-once": ("jit_stability_bad.py", "jit_stability_good.py"),
    "donated-buffer-aliasing": ("donated_aliasing_bad.py",
                                "donated_aliasing_good.py"),
}
RULE_FIXTURES = {**{r: (REF_FIXTURES, *p) for r, p in COPIED.items()},
                 **{r: (FIXTURES, *p) for r, p in ADAPTED.items()}}
OMITTED = {"tracer-safety"}


def lint(paths, root, rules=None, baseline=None):
    findings, project = analysis.run(paths, root=root, rules=rules)
    kept, n_inline, n_base = analysis.filter_suppressed(
        findings, project, baseline or set())
    return kept, n_inline, n_base


@pytest.fixture(scope="module")
def tree():
    """One whole-tree run of every rule: (findings, project, profile,
    seconds)."""
    profile = {}
    t0 = time.perf_counter()
    findings, project = analysis.run(TREE_PATHS, REPO, profile=profile)
    return findings, project, profile, time.perf_counter() - t0


# -- the acceptance gate ----------------------------------------------------

def test_tree_is_clean(tree):
    findings, project, _, _ = tree
    baseline = analysis.load_baseline(BASELINE)
    assert baseline == set()
    kept, n_inline, _ = analysis.filter_suppressed(findings, project,
                                                   baseline)
    assert kept == [], "\n".join(f.render() for f in kept)
    assert n_inline > 0


def test_every_honoured_suppression_carries_a_reason(tree):
    """Each ``# lint: disable=`` that absorbs a finding of the port names
    its rule and gives a one-line reason after ``--``."""
    findings, project, _, _ = tree
    by_path = project.by_path()
    bare = []
    for f in findings:
        mod = by_path[f.path]
        if not mod.suppressed(f):
            continue
        lines = mod.source.splitlines()
        here = lines[f.line - 1]
        above = lines[f.line - 2] if f.line > 1 else ""
        directive = here if "lint: disable" in here else above
        rest = directive.split("lint: disable", 1)[1]
        if not rest.startswith("=") or "--" not in rest or \
                not rest.split("--", 1)[1].strip():
            bare.append(f.render())
    assert bare == []


def test_all_rules_registered():
    names = {c.name for c in analysis.get_checkers()}
    assert set(RULE_FIXTURES) <= names
    assert not names & OMITTED
    assert set(analysis.omitted()) == OMITTED
    assert all(reason for reason in analysis.omitted().values())


# -- per-rule fixture corpus ------------------------------------------------

@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_rule_fires_on_bad_fixture(rule):
    root, bad, _ = RULE_FIXTURES[rule]
    kept, _, _ = lint([bad], root, rules=[rule])
    assert kept, f"{rule} found nothing in {bad}"
    assert all(f.rule == rule for f in kept)


@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_rule_silent_on_good_fixture(rule):
    root, _, good = RULE_FIXTURES[rule]
    kept, _, _ = lint([good], root, rules=[rule])
    assert kept == [], "\n".join(f.render() for f in kept)


def test_bad_fixtures_do_not_cross_fire():
    """Each bad fixture trips only its own rule (rule independence)."""
    for rule, (root, bad, _) in RULE_FIXTURES.items():
        kept, _, _ = lint([bad], root)
        assert kept and {f.rule for f in kept} == {rule}, (
            rule, [f.render() for f in kept])


@pytest.mark.parametrize("rule", sorted(ADAPTED))
def test_adapted_good_fixture_silent_under_every_rule(rule):
    _, _, good = RULE_FIXTURES[rule]
    kept, _, _ = lint([good], FIXTURES)
    assert kept == [], "\n".join(f.render() for f in kept)


# -- the copied rules against the reference's -------------------------------

def _ref_lint(paths, root, rules):
    from ceph_tpu import analysis as ref_analysis
    findings, _ = ref_analysis.run(paths, root=root, rules=rules)
    return findings


def _key(findings):
    return [(f.path, f.line, f.rule, f.message) for f in findings]


@pytest.mark.parametrize("rule", sorted(COPIED))
def test_copied_rule_matches_reference_on_its_fixtures(rule):
    bad, good = COPIED[rule]
    for path in (bad, good):
        got = _key(analysis.run([path], root=REF_FIXTURES,
                                rules=[rule])[0])
        assert got == _key(_ref_lint([path], REF_FIXTURES, [rule])), path


def test_copied_rules_match_reference_on_the_fixture_corpus():
    """All thirteen together over every reference fixture at once (the
    cross-module passes see the whole corpus)."""
    rules = sorted(COPIED)
    got = _key(analysis.run(["."], root=REF_FIXTURES, rules=rules)[0])
    assert got == _key(_ref_lint(["."], REF_FIXTURES, rules))
    assert len(got) >= len(COPIED)


def test_copied_rules_match_reference_on_ceph_tpu():
    """Over the reference's own tree (raw findings, before suppressions:
    the ones the reference suppresses inline included)."""
    rules = sorted(COPIED)
    got = _key(analysis.run(["ceph_tpu"], root=REPO, rules=rules)[0])
    assert got == _key(_ref_lint(["ceph_tpu"], REPO, rules))
    assert got, "the reference's tree has suppressed findings to compare"


# -- interprocedural acceptance pins ----------------------------------------

def _write(tmp_path, name, text):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return str(p)


def test_device_path_injection_two_calls_deep(tmp_path):
    """A host sync injected two calls deep (and one module away) from a
    launch entry point is found."""
    _write(tmp_path, "launch.py",
           "import torch\n"
           "from helpers import stage1\n\n\n"
           "class CodecBatcher:\n"
           "    def encode(self, codec, arr):\n"
           "        return stage1(codec, torch.as_tensor(arr))\n")
    _write(tmp_path, "helpers.py",
           "import torch\n\n\n"
           "def stage1(codec, arr):\n"
           "    return _stage2(codec.encode_batch(arr))\n\n\n"
           "def _stage2(out):\n"
           "    return out.tolist()\n")
    kept, _, _ = lint(["launch.py", "helpers.py"], str(tmp_path),
                      rules=["device-path-host-sync"])
    assert len(kept) == 1, [f.render() for f in kept]
    assert kept[0].path == "helpers.py"
    assert "CodecBatcher.encode" in kept[0].message


def test_sched_launch_host_sync_flagged(tmp_path):
    """A host sync hiding inside the scheduled launch's helpers is found:
    the scheduled-kernel entry points are roots."""
    _write(tmp_path, "xsched.py",
           "import numpy as np\n"
           "import torch\n\n\n"
           "def sched_matmul_batch_device(sched, matrix, x):\n"
           "    return _run_ops(sched, x.to('cuda'))\n\n\n"
           "def _run_ops(sched, xd):\n"
           "    torch.cuda.synchronize()   # the smuggled host wait\n"
           "    return xd\n")
    kept, _, _ = lint(["xsched.py"], str(tmp_path),
                      rules=["device-path-host-sync"])
    assert len(kept) == 1, [f.render() for f in kept]
    assert "sched_matmul_batch_device" in kept[0].message


def test_device_path_numpy_asarray_of_numpy_is_free(tmp_path):
    """``np.asarray`` of a numpy array (the reference's most common
    finding) is no finding; of a tensor it is, and only after the name
    is bound to one."""
    _write(tmp_path, "k.py",
           "import numpy as np\n"
           "import torch\n\n\n"
           "def crc32c_rows(arr, lengths=None):\n"
           "    a = np.asarray(arr, np.uint8)\n"
           "    lens = np.asarray(lengths)\n"
           "    rows = np.asarray(a)\n"
           "    t = torch.from_numpy(rows).cuda()\n"
           "    return np.asarray(t)\n")
    kept, _, _ = lint(["k.py"], str(tmp_path),
                      rules=["device-path-host-sync"])
    assert [f.line for f in kept] == [10], [f.render() for f in kept]
    assert "np.asarray of a tensor" in kept[0].message


def test_device_path_fences(tmp_path):
    """The walk stays in torch modules, and reads on a branch that just
    tested for the CPU are the plain version's."""
    _write(tmp_path, "launch.py",
           "import torch\n"
           "from host import finish\n\n\n"
           "def gf_matmul_batch_device(matrix, x):\n"
           "    if x.device.type == 'cpu':\n"
           "        return x.numpy().sum()\n"
           "    return finish(x)\n")
    _write(tmp_path, "host.py",
           "def finish(out):\n"
           "    return out.cpu()          # a host-only module\n")
    kept, _, _ = lint(["launch.py", "host.py"], str(tmp_path),
                      rules=["device-path-host-sync"])
    assert kept == [], [f.render() for f in kept]


def test_donated_roots_flag_rmw_reuse(tmp_path):
    """A device buffer read after being fed into MeshCodec.rmw through a
    forwarding wrapper (one module away) is a use-after-donate finding."""
    _write(tmp_path, "meshy.py",
           "import torch\n\n\n"
           "class MeshCodec:\n"
           "    def rmw(self, codec, old_parity, delta, out_np=True):\n"
           "        old_parity.bitwise_xor_(delta)\n"
           "        return old_parity\n\n\n"
           "def update(mesh, codec, old, delta):\n"
           "    return mesh.rmw(codec, old, delta)\n")
    _write(tmp_path, "user.py",
           "import torch\n"
           "from meshy import update\n\n\n"
           "def write(mesh, codec, dev, delta):\n"
           "    out = update(mesh, codec, dev, delta)\n"
           "    return out, dev.sum()   # read-after-donate\n")
    kept, _, _ = lint(["meshy.py", "user.py"], str(tmp_path),
                      rules=["donated-buffer-aliasing"])
    assert len(kept) == 1, [f.render() for f in kept]
    assert kept[0].path == "user.py" and "dev" in kept[0].message


def test_kernel_build_once_memo_and_cache(tmp_path):
    """A loader behind a memo test or an lru_cache is silent on the
    launch path; an uncached per-launch load is a finding."""
    _write(tmp_path, "k.py",
           "import ctypes\nimport functools\nimport torch\n\n"
           "_LIB = None\n\n\n"
           "def memo():\n"
           "    global _LIB\n"
           "    if _LIB is None:\n"
           "        _LIB = ctypes.CDLL('libk.so')\n"
           "    return _LIB\n\n\n"
           "@functools.lru_cache(maxsize=1)\n"
           "def cached():\n"
           "    return ctypes.CDLL('libk.so')\n\n\n"
           "def fresh():\n"
           "    return ctypes.CDLL('libk.so')\n\n\n"
           "def crc32c_chunks(x: torch.Tensor):\n"
           "    return memo(), cached(), fresh()\n")
    kept, _, _ = lint(["k.py"], str(tmp_path), rules=["kernel-build-once"])
    assert [f.line for f in kept] == [21], [f.render() for f in kept]
    assert "crc32c_chunks" in kept[0].message


def test_torch_global_state_only_at_import(tmp_path):
    _write(tmp_path, "m.py",
           "import torch as t\n\n"
           "t.set_default_dtype(t.float64)\n\n\n"
           "def f():\n"
           "    t.set_default_dtype(t.float64)\n")
    kept, _, _ = lint(["m.py"], str(tmp_path), rules=["torch-global-state"])
    assert [f.line for f in kept] == [3], [f.render() for f in kept]


def test_wire_safety_flags_a_live_tensor(tmp_path):
    _write(tmp_path, "w.py",
           "import torch\n"
           "from msg import Message\n\n\n"
           "def reply(conn):\n"
           "    conn.send(Message('osd_op_reply', "
           "{'data': torch.zeros(4)}))\n")
    kept, _, _ = lint(["w.py"], str(tmp_path), rules=["wire-safety"])
    live = [f for f in kept if "torch tensor" in f.message]
    assert len(live) == 1 and live[0].line == 6, [f.render() for f in kept]


def test_device_path_roots_resolve(tree):
    """Every launch entry point of the rule (and of donated-buffer-
    aliasing) names a real function of the port."""
    from ceph_tpu_torch.analysis.checkers import device_path, donated_aliasing
    graph = tree[1].graph()
    specs = list(device_path.ROOTS) + [s for s, _ in donated_aliasing.ROOTS]
    missing = [spec for spec in specs if not graph.lookup(spec)]
    assert missing == [], missing


LINT_BUDGET_SECONDS = 75.0


def test_full_tree_lint_within_time_budget(tree):
    """The whole-tree run -- parse, call graph, every rule -- stays
    affordable: ~5x its cost on a CPU of the test host."""
    _, _, profile, elapsed = tree
    assert elapsed < LINT_BUDGET_SECONDS, (
        f"full-tree lint took {elapsed:.1f}s "
        f"(budget {LINT_BUDGET_SECONDS}s); slowest rules: "
        f"{sorted(profile.items(), key=lambda kv: -kv[1])[:5]}")
    assert "[parse]" in profile and "[callgraph]" in profile


# -- suppression round-trips ------------------------------------------------

BAD_SNIPPET = "import torch\ntorch.set_default_dtype(torch.float64)\n"


def test_inline_suppression_same_line(tmp_path):
    _write(tmp_path, "mod.py", BAD_SNIPPET.replace(
        "float64)", "float64)  # lint: disable=torch-global-state"))
    kept, n_inline, _ = lint(["mod.py"], str(tmp_path))
    assert kept == [] and n_inline == 1


def test_inline_suppression_standalone_line_above(tmp_path):
    _write(tmp_path, "mod.py",
           "import torch\n# lint: disable=torch-global-state\n"
           "torch.set_default_dtype(torch.float64)\n")
    kept, n_inline, _ = lint(["mod.py"], str(tmp_path))
    assert kept == [] and n_inline == 1


def test_inline_suppression_wrong_rule_does_not_apply(tmp_path):
    _write(tmp_path, "mod.py", BAD_SNIPPET.replace(
        "float64)", "float64)  # lint: disable=hole-sentinel"))
    kept, n_inline, _ = lint(["mod.py"], str(tmp_path))
    assert len(kept) == 1 and n_inline == 0


def test_inline_suppression_bare_disable_suppresses_all(tmp_path):
    _write(tmp_path, "mod.py", BAD_SNIPPET.replace(
        "float64)", "float64)  # lint: disable"))
    kept, n_inline, _ = lint(["mod.py"], str(tmp_path))
    assert kept == [] and n_inline == 1


def test_baseline_roundtrip(tmp_path):
    _write(tmp_path, "mod.py", BAD_SNIPPET)
    kept, _, _ = lint(["mod.py"], str(tmp_path))
    assert len(kept) == 1
    bl_path = str(tmp_path / "baseline.txt")
    analysis.write_baseline(bl_path, kept)
    baseline = analysis.load_baseline(bl_path)
    kept2, _, n_base = lint(["mod.py"], str(tmp_path), baseline=baseline)
    assert kept2 == [] and n_base == 1
    _write(tmp_path, "mod.py", "import os  # noqa\n" + BAD_SNIPPET)
    kept3, _, n_base3 = lint(["mod.py"], str(tmp_path), baseline=baseline)
    assert kept3 == [] and n_base3 == 1


def test_inline_suppression_project_rule(tmp_path):
    _write(tmp_path, "driver.py",
           "def probe(mon):\n"
           "    # lint: disable=cross-daemon-state -- test shortcut\n"
           "    return mon._stopped\n")
    kept, n_inline, _ = lint(["driver.py"], str(tmp_path))
    assert kept == [] and n_inline == 1


def test_baseline_roundtrip_project_rule(tmp_path):
    _write(tmp_path, "driver.py",
           "def probe(mon):\n    return mon._stopped\n")
    kept, _, _ = lint(["driver.py"], str(tmp_path))
    assert len(kept) == 1 and kept[0].rule == "cross-daemon-state"
    bl_path = str(tmp_path / "baseline.txt")
    analysis.write_baseline(bl_path, kept)
    kept2, _, n_base = lint(["driver.py"], str(tmp_path),
                            baseline=analysis.load_baseline(bl_path))
    assert kept2 == [] and n_base == 1


def test_await_snapshot_suppression_roundtrip(tmp_path):
    _write(tmp_path, "osd/loop.py",
           "import asyncio\n\nSTATE = {}\n\n\n"
           "async def tick(k):\n"
           "    v = STATE[k]\n"
           "    await asyncio.sleep(0)\n"
           "    # lint: disable=await-invalidates-snapshot -- why\n"
           "    return v\n")
    kept, n_inline, _ = lint(["osd/loop.py"], str(tmp_path))
    assert kept == [] and n_inline == 1


def test_syntax_error_is_a_parse_finding(tmp_path):
    _write(tmp_path, "mod.py", "def broken(:\n")
    kept, _, _ = lint(["mod.py"], str(tmp_path))
    assert len(kept) == 1 and kept[0].rule == "parse"


def test_unknown_rule_raises():
    with pytest.raises(KeyError):
        analysis.run(["device_path_bad.py"], root=FIXTURES,
                     rules=["no-such-rule"])
    with pytest.raises(KeyError):
        analysis.run(["device_path_bad.py"], root=FIXTURES,
                     rules=["tracer-safety"])


# -- CLI --------------------------------------------------------------------

def _cli(*argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.lint", *argv],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_full_tree_exits_zero():
    res = _cli()
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == ""
    assert "0 finding(s)" in res.stderr


def test_cli_list_rules_names_every_rule_and_omission():
    res = _cli("--list-rules")
    assert res.returncode == 0
    for rule in RULE_FIXTURES:
        assert rule in res.stdout
    assert "tracer-safety" in res.stdout and "omitted:" in res.stdout


def test_cli_nonzero_on_findings_and_rule_filter():
    bad = os.path.join("tests", "torch_lint_fixtures", "x64_scope_bad.py")
    res = _cli("--rules", "torch-global-state", bad)
    assert res.returncode == 1
    assert "torch-global-state" in res.stdout
    res2 = _cli("--rules", "hole-sentinel", bad)
    assert res2.returncode == 0


def test_cli_profile_and_formats():
    res = _cli("--profile", "ceph_tpu_torch/analysis")
    assert res.returncode == 0, res.stdout + res.stderr
    for key in ("[parse]", "[callgraph]", "[total]", "device-path-host-sync",
                "kernel-build-once", "torch-global-state"):
        assert key in res.stderr
    bad = os.path.join("tests", "torch_lint_fixtures", "jit_stability_bad.py")
    res = _cli("--rules", "kernel-build-once", "--format", "json", bad)
    assert res.returncode == 1
    data = json.loads(res.stdout)
    assert data and {d["rule"] for d in data} == {"kernel-build-once"}
    res = _cli("--rules", "kernel-build-once", "--format", "sarif", bad)
    doc = json.loads(res.stdout)
    assert res.returncode == 1 and doc["version"] == "2.1.0"
    assert {"id": "kernel-build-once"} in doc["runs"][0]["tool"]["driver"][
        "rules"]
    res = _cli("--format", "json", "ceph_tpu_torch/common")
    assert res.returncode == 0 and json.loads(res.stdout) == []


def test_cli_changed_mode_runs():
    res = _cli("--changed")
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_seam_report_needs_a_path_and_writes_only_there(tmp_path):
    res = _cli("--seam-report")
    assert res.returncode == 2              # no default path
    before = os.path.getmtime(os.path.join(REPO, "SEAM_AUDIT.json"))
    out = str(tmp_path / "audit.json")
    res = _cli("--seam-report", out)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["schema"] == "ceph-tpu-seam-audit-v1"
    s = doc["summary"]
    assert s["shared_state_sites"] >= 10 and s["wire_types"] >= 30
    assert s["unsafe_wire_types"] == []
    assert s["unjustified_daemon_reaches"] == 0
    assert s["unjustified_snapshot_races"] == 0
    assert os.path.getmtime(os.path.join(REPO, "SEAM_AUDIT.json")) == before
