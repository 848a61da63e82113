"""Built-in project rules; importing this package registers them.

Port of ``ceph_tpu/analysis/checkers/``: the same modules.  Thirteen
rules are the reference's, unchanged; ``device_path``, ``x64_scope``
(``torch-global-state``), ``jit_stability`` (``kernel-build-once``) and
``donated_aliasing`` are their torch counterparts, and ``tracer_safety``
records its omission (``registry.omitted``).
"""

from . import (        # noqa: F401
    await_snapshot,
    await_under_lock,
    blocking_under_lock,
    config_schema,
    cross_daemon_state,
    counter_coverage,
    denc_symmetry,
    device_path,
    donated_aliasing,
    dropped_task,
    hole_sentinel,
    hot_config,
    jit_stability,
    lock_order,
    perf_coherence,
    tracer_safety,
    wire_safety,
    x64_scope,
)
