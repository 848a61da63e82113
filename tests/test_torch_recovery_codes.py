"""The recovery-optimal codes' drives (LRC k=4,m=4,l=2 and PMSR k=3,m=2 of
``code_configs(smoke=True)``) in ``ceph_tpu`` and ``ceph_tpu_torch`` on the
CPU: the same ``ec_recovery`` counter deltas, every object read back
intact (``test_torch_recovery_bench.py`` holds the RS drive and the
gates)."""

import pytest

from ceph_tpu.tools import recovery_bench as ref
from ceph_tpu_torch.tools import recovery_bench as port
from test_torch_recovery_bench import SMOKE, _quiet, check_drives, run


@pytest.mark.parametrize("name", ["lrc", "pmsr"])
def test_recovery_round_counters_match_reference(name):
    specs = {s["name"]: s for s in ref.code_configs(smoke=True)}
    want = run(ref._drive_code(specs[name], log=_quiet, **SMOKE))
    got = run(port.drive_code(
        next(s for s in port.code_configs(smoke=True) if s["name"] == name),
        log=_quiet, device="cpu", **SMOKE))
    check_drives(name, want, got)
