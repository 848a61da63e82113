"""The port's recovery bench (``ceph_tpu_torch/tools/recovery_bench.py``)
against ``ceph_tpu/tools/recovery_bench.py`` on the CPU.

Each code of ``code_configs(smoke=True)`` (RS on ``cuda`` where the
reference names ``tpu``, LRC k=4,m=4,l=2, PMSR k=3,m=2) is driven through
``chaos.recovery_round`` (kill, degraded rewrite, revive, recover, read
back past a survivor kill) on a cluster of each package, at ``bench.py
--recovery --smoke``'s sizes; the ``ec_recovery`` counter deltas must be
equal and no object may differ.  RS here, LRC and PMSR in
``test_torch_recovery_codes.py`` (the drives take seconds each).  The
port's three drives then pass ``recovery_gates``, whose ratios are of
counters, not of times.
"""

import asyncio

import pytest

from ceph_tpu.tools import recovery_bench as ref
from ceph_tpu_torch.tools import recovery_bench as port

SMOKE = dict(n_objects=4, obj_size=32 << 10, pg_num=8, seed=7)
COUNTERS = ("repair_bytes_read", "repair_bytes_shipped", "repair_reads",
            "repair_local_repairs", "repair_global_decodes",
            "repair_fragment_pulls", "read_per_shipped")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def port_drives() -> dict:
    return {spec["name"]: run(port.drive_code(spec, log=_quiet,
                                              device="cpu", **SMOKE))
            for spec in port.code_configs(smoke=True)}


def check_drives(name: str, want: dict, got: dict) -> None:
    """One code's drive in each package: clean, and the same counters."""
    assert got["plugin"] == ("cuda" if name == "rs" else name)
    for res in (want, got):
        assert res["mismatched"] == [] and res["errors"] == [], res
        assert res["recovered_clean"], res
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["repair_bytes_shipped"] > 0
    assert (got["k"], got["m"], got["width"]) == \
        (want["k"], want["m"], want["width"])


def test_rs_recovery_round_counters_match_reference(port_drives):
    spec = next(s for s in ref.code_configs(smoke=True) if s["name"] == "rs")
    check_drives("rs", run(ref._drive_code(spec, log=_quiet, **SMOKE)),
                 port_drives["rs"])


def test_port_drives_pass_the_bench_gates(port_drives):
    res = port.recovery_summary(port_drives, dict(SMOKE))
    assert port.recovery_gates(res) == []
    assert res["lrc_vs_rs_read_ratio"] == 0.5      # l/k = 2/4, the boundary
    assert res["pmsr_read_chunks"] == 2.0          # d/alpha = 4/2
    spoiled = port.recovery_summary(
        {**port_drives, "lrc": {**port_drives["lrc"],
                                "repair_local_repairs": 0,
                                "read_per_shipped": 4.0}}, dict(SMOKE))
    errs = port.recovery_gates(spoiled)
    assert any("never repaired locally" in e for e in errs)
    assert any("of RS (gate: <= 0.5x)" in e for e in errs)
