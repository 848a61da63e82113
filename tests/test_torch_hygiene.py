"""The port stands alone: ceph_tpu_torch and chip_smoke.py import neither
JAX nor anything of the ceph_tpu package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ceph_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names + ["chip_smoke"]


def test_port_sources_import_no_jax_or_ceph_tpu():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 10


def test_importing_the_port_loads_no_jax_or_ceph_tpu():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


CLIENT_APPS = ("client/striper.py", "client/object_cacher.py",
               "client/radosstriper.py", "rbd/__init__.py", "rbd/crypto.py",
               "rbd/features.py", "rbd/migration.py", "rbd/mirror.py",
               "rbd/rbd.py", "rgw/__init__.py", "rgw/client.py",
               "rgw/gateway.py", "rgw/notify.py", "rgw/store.py",
               "rgw/swift.py")


def test_the_client_applications_have_their_port():
    """Each client-application module of ceph_tpu has its counterpart in
    the port, whose imports the checks above cover; the client package
    exports the striper as the reference's does."""
    missing = [rel for rel in CLIENT_APPS if not (PORT / rel).is_file()
               or not (ROOT / "ceph_tpu" / rel).is_file()]
    assert not missing, missing
    import ceph_tpu_torch.client as port_client
    assert {"Layout", "RadosStriper"} <= set(port_client.__all__)


DEPLOYMENT = ("mgr/__init__.py", "mgr/mgr.py", "mgr/prometheus.py",
              "mds/__init__.py", "mds/client.py", "mds/fs_mirror.py",
              "mds/journal.py", "mds/server.py", "tools/__init__.py",
              "tools/vstart.py", "tools/ceph_cli.py", "tools/rados_cli.py",
              "tools/cephfs_cli.py", "tools/cephfs_mirror.py",
              "tools/exporter.py", "tools/rbd_cli.py", "tools/rgw_cli.py",
              "tools/rbd_mirror.py")


def test_the_deployment_layer_has_its_port():
    """Each module of ceph_tpu's deployment layer (the mgr, the MDS and
    CephFS, vstart and the CLIs) has its counterpart in the port, whose
    imports the checks above cover, beside the port's own CephFS drive;
    the packages export what the reference's do."""
    missing = [rel for rel in DEPLOYMENT if not (PORT / rel).is_file()
               or not (ROOT / "ceph_tpu" / rel).is_file()]
    assert not missing, missing
    assert (PORT / "tools" / "fs_drive.py").is_file()
    import ceph_tpu_torch.mds as port_mds
    import ceph_tpu_torch.mgr as port_mgr
    from ceph_tpu_torch.tools import parse_addr
    assert set(port_mds.__all__) == {"MDS", "CephFS", "FsError"}
    assert {"Mgr", "MgrModule"} <= set(dir(port_mgr))
    assert parse_addr("10.0.0.1:6790") == ("10.0.0.1", 6790)
    assert parse_addr("") == ("127.0.0.1", 6789)


HOST_EC_PLUGINS = ("gf/gf2w.py", "ec/gf2w_region.py", "ec/bitmatrix_codec.py",
                   "ec/plugins/jerasure.py", "ec/plugins/shec.py",
                   "ec/plugins/clay.py", "ec/plugins/example.py")


def test_the_host_ec_plugins_have_their_port():
    """Each module of ceph_tpu's host EC plugins has its counterpart in the
    port, whose imports the checks above cover, and the port's registry
    serves all eight plugins, the four host ones beside the others."""
    missing = [rel for rel in HOST_EC_PLUGINS if not (PORT / rel).is_file()
               or not (ROOT / "ceph_tpu" / rel).is_file()]
    assert not missing, missing
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    reg = ErasureCodePluginRegistry()
    for name in ("cuda", "isa", "lrc", "pmsr", "jerasure", "shec", "clay",
                 "example"):
        assert reg.load(name) is reg.get(name)


OFFLINE_AND_ANALYSIS = (
    "tools/dencoder.py", "tools/monstore_tool.py", "tools/objectstore_tool.py",
    "analysis/__init__.py", "analysis/astutil.py", "analysis/callgraph.py",
    "analysis/core.py", "analysis/project.py", "analysis/registry.py",
    "analysis/seam_report.py", "analysis/checkers/__init__.py",
    *(f"analysis/checkers/{name}.py" for name in (
        "await_snapshot", "await_under_lock", "blocking_under_lock",
        "config_schema", "counter_coverage", "cross_daemon_state",
        "denc_symmetry", "device_path", "donated_aliasing", "dropped_task",
        "hole_sentinel", "hot_config", "jit_stability", "lock_order",
        "perf_coherence", "tracer_safety", "wire_safety", "x64_scope")))


def test_the_offline_tools_and_analysis_have_their_port():
    """The offline tools and the static analysis of ceph_tpu have their
    counterparts in the port, whose imports the checks above cover; the
    port's lint has its own front end and an empty baseline beside it."""
    missing = [rel for rel in OFFLINE_AND_ANALYSIS if not (PORT / rel).is_file()
               or not (ROOT / "ceph_tpu" / rel).is_file()]
    assert not missing, missing
    assert (PORT / "tools" / "lint.py").is_file()
    baseline = (PORT / "tools" / "lint_baseline.txt").read_text().splitlines()
    assert all(not line.strip() or line.startswith("#") for line in baseline)
    from ceph_tpu_torch import analysis
    from ceph_tpu_torch.tools import dencoder
    assert {"PGInfo", "LogEntry", "WireMessage"} <= set(dencoder.TYPES)
    assert len(analysis.get_checkers()) + len(analysis.omitted()) == 18


# the JAX package's entry points, and their counterparts named for the card
RENAMED = {"ops/jax_backend.py": "ops/torch_backend.py",
           "ec/plugins/tpu.py": "ec/plugins/cuda.py"}


def test_every_module_of_ceph_tpu_has_its_port():
    """Each ``.py`` file of ceph_tpu has a file of the same path in the
    port, but for the two entry points named for the card, whose
    counterparts stand under their own names."""
    ref = ROOT / "ceph_tpu"
    missing = [str(rel) for rel in (p.relative_to(ref)
                                    for p in sorted(ref.rglob("*.py")))
               if not (PORT / RENAMED.get(rel.as_posix(), rel)).is_file()]
    assert not missing, missing
    assert all((ref / rel).is_file() and (PORT / new).is_file()
               for rel, new in RENAMED.items())
