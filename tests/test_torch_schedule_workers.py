"""``chip_smoke.compile_schedules``, phase 1's host CSE in worker processes:
the schedules and the process-wide cache equal a serial compile's.  Phase
1 builds the matrices with ``CEPH_TPU_XOR_SCHED=0``, so the codecs do not
warm (compile) their schedules one after another on the way."""

import numpy as np

import chip_smoke
from ceph_tpu_torch import device
from ceph_tpu_torch.ops import gf2kernels as gk
from ceph_tpu_torch.ops import xor_schedule as xs

LABELS = ("rs8/3 parity", "rs8/3 decode[1,9]", "lrc8/4/3 parity",
          "lrc8/4/3 local repair", "pmsr3/2 parity", "pmsr3/2 aggregate",
          "unit, zero, repeated rows")


def test_worker_schedules_equal_a_serial_compile(monkeypatch):
    # the codecs path_matrices builds its matrices with, on the CPU
    monkeypatch.setattr(device, "DEFAULT_DEVICE", "cpu")
    xs.clear_schedule_cache()
    with chip_smoke.xor_sched_env("0"):
        everything = chip_smoke.path_matrices()
    assert not xs._SCHEDULES            # built, not warmed
    mats = {label: m for label, m in everything.items() if label in LABELS}
    assert sorted(mats) == sorted(LABELS)
    serial = {label: xs.compile_schedule(gk.bitmatrix_i8(m))
              for label, m in mats.items()}
    xs.clear_schedule_cache()
    try:
        got = chip_smoke.compile_schedules(mats, workers=2)
        assert got == serial
        for label, m in mats.items():
            bits = gk.bitmatrix_i8(m)
            assert xs.cached_schedule(bits) is got[label]
            assert got[label].digest == xs.matrix_digest(bits)
        # a schedule two labels share is one cache entry
        assert len(xs._SCHEDULES) == len({s.digest for s in got.values()})
        assert all(np.array_equal(np.asarray(got[k].outputs, dtype=object),
                                  np.asarray(serial[k].outputs, dtype=object))
                   for k in got)
    finally:
        xs.clear_schedule_cache()
