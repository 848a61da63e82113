"""The port's interprocedural layer (ceph_tpu_torch.analysis project
model + call graph): the cases of ``tests/test_callgraph.py`` on the
port's framework (import resolution, method/inheritance resolution, fuzzy
fan-out, forward/reverse reachability, spawn-aware edges, dynamic getattr
dispatch, lock-region tagging, the --changed caller-expansion closure),
the real-tree smoke on ``ceph_tpu_torch/`` paths, and the port's graph
over ``ceph_tpu/`` held against the reference's edge for edge."""

import os

import pytest

from ceph_tpu_torch import analysis
from ceph_tpu_torch.analysis.core import changed_closure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(tmp_path, files):
    for name, text in files.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    _, project = analysis.run(sorted(files), root=str(tmp_path),
                              rules=[])
    return project


def graph_of(tmp_path, files):
    return build(tmp_path, files).graph()


# -- import / symbol resolution ---------------------------------------------

def test_from_import_call_resolves_precisely(tmp_path):
    g = graph_of(tmp_path, {
        "pkg/a.py": "def helper():\n    return 1\n",
        "pkg/b.py": ("from pkg.a import helper\n\n"
                     "def caller():\n    return helper()\n"),
    })
    assert g.calls["pkg/b.py::caller"]["pkg/a.py::helper"] == 1


def test_relative_import_resolves(tmp_path):
    g = graph_of(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/a.py": "def helper():\n    return 1\n",
        "pkg/b.py": ("from .a import helper\n\n"
                     "def caller():\n    return helper()\n"),
    })
    assert g.calls["pkg/b.py::caller"]["pkg/a.py::helper"] == 1


def test_module_alias_attribute_call_resolves(tmp_path):
    g = graph_of(tmp_path, {
        "pkg/a.py": "def helper():\n    return 1\n",
        "pkg/b.py": ("import pkg.a as pa\n\n"
                     "def caller():\n    return pa.helper()\n"),
    })
    assert g.calls["pkg/b.py::caller"]["pkg/a.py::helper"] == 1


def test_self_method_resolves_through_base_class(tmp_path):
    g = graph_of(tmp_path, {
        "base.py": ("class Base:\n"
                    "    def shared(self):\n        return 0\n"),
        "sub.py": ("from base import Base\n\n"
                   "class Sub(Base):\n"
                   "    def caller(self):\n"
                   "        return self.shared()\n"),
    })
    assert g.calls["sub.py::Sub.caller"]["base.py::Base.shared"] == 1


def test_class_constructor_resolves_to_init(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("class Thing:\n"
                 "    def __init__(self):\n        self.x = 1\n"),
        "b.py": ("from a import Thing\n\n"
                 "def make():\n    return Thing()\n"),
    })
    assert g.calls["b.py::make"]["a.py::Thing.__init__"] == 1


def test_fuzzy_edge_carries_fanout(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("class A:\n"
                 "    def launch(self):\n        return 1\n"),
        "b.py": ("class B:\n"
                 "    def launch(self):\n        return 2\n"),
        "c.py": "def go(x):\n    return x.launch()\n",
    })
    edges = g.calls["c.py::go"]
    assert edges["a.py::A.launch"] == 2
    assert edges["b.py::B.launch"] == 2
    # a tight traversal refuses the ambiguous edge
    assert g.reachable(["c.py::go"], max_fanout=1) == {"c.py::go"}
    assert "a.py::A.launch" in g.reachable(["c.py::go"], max_fanout=2)


# -- reachability ------------------------------------------------------------

CHAIN = {
    "a.py": ("from b import mid\n\n"
             "def top():\n    return mid()\n"),
    "b.py": ("from c import leaf\n\n"
             "def mid():\n    return leaf()\n"),
    "c.py": "def leaf():\n    return 1\n",
}


def test_forward_reachability_is_transitive(tmp_path):
    g = graph_of(tmp_path, CHAIN)
    seen = g.reachable(["a.py::top"])
    assert {"a.py::top", "b.py::mid", "c.py::leaf"} <= seen


def test_reverse_callers_is_transitive(tmp_path):
    g = graph_of(tmp_path, CHAIN)
    callers = g.callers(["c.py::leaf"])
    assert {"a.py::top", "b.py::mid", "c.py::leaf"} <= callers
    # direction check: top has no callers beyond itself (and module
    # roots, which make no calls in this fixture)
    assert "c.py::leaf" not in g.callers(["a.py::top"]) - {"a.py::top"}


def test_changed_closure_expands_dirty_set_with_callers(tmp_path):
    project = build(tmp_path, CHAIN)
    closure = changed_closure(project, {"c.py"})
    # an edit to the leaf re-analyzes everything that can reach it
    assert closure == {"a.py", "b.py", "c.py"}
    # an edit to the top re-analyzes only itself
    assert changed_closure(project, {"a.py"}) == {"a.py"}


# -- spawn-aware edges --------------------------------------------------------

def test_spawned_call_is_edge_but_not_synchronous(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("import asyncio\n\n"
                 "async def worker():\n    return 1\n\n"
                 "def kick():\n"
                 "    t = asyncio.ensure_future(worker())\n"
                 "    return t\n"),
    })
    # liveness sees the spawned callee...
    assert "a.py::worker" in g.reachable(["a.py::kick"])
    # ...lock-holding analysis does not
    assert "a.py::worker" not in g.reachable(["a.py::kick"],
                                             spawn=False)


def test_direct_call_elsewhere_clears_spawn_only(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("import asyncio\n\n"
                 "async def worker():\n    return 1\n\n"
                 "async def kick():\n"
                 "    t = asyncio.ensure_future(worker())\n"
                 "    await worker()\n    return t\n"),
    })
    assert "a.py::worker" in g.reachable(["a.py::kick"], spawn=False)


# -- dynamic dispatch ---------------------------------------------------------

def test_getattr_prefix_dispatch_marks_handlers_live(tmp_path):
    g = graph_of(tmp_path, {
        "d.py": ("class D:\n"
                 "    def dispatch(self, msg):\n"
                 "        h = getattr(self, f'_h_{msg.type}', None)\n"
                 "        return h(msg)\n\n"
                 "    def _h_ping(self, msg):\n        return msg\n\n"
                 "    def _unrelated(self):\n        return 0\n"),
    })
    live = g.reachable(g.entry_points(), refs=True)
    assert "d.py::D._h_ping" in live
    assert "d.py::D._unrelated" not in live


# -- lookup / lock regions ----------------------------------------------------

def test_lookup_by_class_method_spec(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("class CodecBatcher:\n"
                 "    def encode(self):\n        return 1\n\n"
                 "def encode():\n    return 2\n"),
    })
    assert g.lookup("CodecBatcher.encode") == [
        "a.py::CodecBatcher.encode"]
    assert "a.py::encode" in g.lookup("encode")


def test_lock_regions_are_tagged(tmp_path):
    g = graph_of(tmp_path, {
        "a.py": ("import asyncio\n\n"
                 "class A:\n"
                 "    def __init__(self):\n"
                 "        self._pg_lock = asyncio.Lock()\n\n"
                 "    async def work(self):\n"
                 "        async with self._pg_lock:\n"
                 "            self.step()\n\n"
                 "    def step(self):\n        return 1\n"),
    })
    regions = [r for r in g.lock_regions
               if r.owner == "a.py::A.work"]
    assert len(regions) == 1
    region = regions[0]
    assert region.locks == ["A._pg_lock"]
    assert region.is_async
    assert ("a.py::A.step", 1) in region.callees


# -- the real tree ------------------------------------------------------------

def test_real_tree_graph_sanity():
    """The production graph resolves the module-qualified call spine
    the rules depend on (smoke, not exhaustiveness)."""
    _, project = analysis.run(["ceph_tpu_torch/osd/ec_util.py",
                               "ceph_tpu_torch/osd/codec_batcher.py"],
                              root=REPO, rules=[])
    g = project.graph()
    assert g.lookup("CodecBatcher.encode")
    assert g.lookup("StripeInfo.encode_async")
    enc = g.lookup("StripeInfo.encode_async")[0]
    # encode_async submits through the batcher
    reach = g.reachable([enc])
    assert any("codec_batcher.py::CodecBatcher." in q for q in reach)


# -- daemon-boundary reachability (cross-daemon-state helper) ----------------

def test_reach_origin_daemons_charges_shared_helper(tmp_path):
    """A boundary reach inside a shared helper is charged to every
    daemon class whose code can run it -- plain-function callers
    (tools, loadgen) contribute no daemon origin."""
    from ceph_tpu_torch.analysis.checkers.cross_daemon_state import (
        reach_origin_daemons)
    g = graph_of(tmp_path, {
        "helpers.py": ("def peek(mon):\n"
                       "    return mon._stopped\n"),
        "osd/osd.py": ("from helpers import peek\n\n\n"
                       "class OSD:\n"
                       "    def check(self, mon):\n"
                       "        return peek(mon)\n"),
        "tools/drive.py": ("from helpers import peek\n\n\n"
                           "def drive(mon):\n"
                           "    return peek(mon)\n"),
    })
    assert reach_origin_daemons(g, "helpers.py::peek") == {"OSD"}


# -- the port's graph against the reference's --------------------------------

def _graph_record(g):
    """Everything a rule reads off a CallGraph, as plain data."""
    return {
        "functions": {q: (fi.local, fi.path, fi.cls, fi.is_async, fi.lineno)
                      for q, fi in g.functions.items()},
        "calls": g.calls,
        "spawn_only": {k: v for k, v in g.spawn_only.items() if v},
        "refs": g.refs,
        "lock_regions": sorted(
            (r.owner, r.path, r.line, tuple(r.locks), r.is_async,
             tuple(sorted(r.callees)), tuple(r.inner_locks))
            for r in g.lock_regions),
        "aliases": {p: s.aliases for p, s in g.symbols.items()},
    }


@pytest.mark.parametrize("paths", [["ceph_tpu"], ["ceph_tpu/osd"]])
def test_port_graph_equals_the_reference_edge_for_edge(paths):
    """Over the reference's own tree, the port's CallGraph is the
    reference's: the same functions, call edges with their fan-outs,
    spawn-only edges, references, lock regions and import tables."""
    from ceph_tpu import analysis as ref_analysis
    _, ref = ref_analysis.run(paths, root=REPO, rules=[])
    _, port = analysis.run(paths, root=REPO, rules=[])
    want, got = _graph_record(ref.graph()), _graph_record(port.graph())
    assert got["functions"] and got["calls"]
    for key in want:
        assert got[key] == want[key], key
