"""Cluster-scale closed-loop traffic harness.

Port of ``ceph_tpu/loadgen/``: ``stats`` (the process-wide "workload"
counter set the OSD adopts), ``cluster`` (``SimCluster``: a monitor and N
OSDs in one process, with kill, revive and wait helpers), ``spec``
(``WorkloadSpec``), ``histogram``, ``swarm`` (``ClientSwarm``) and
``driver`` (``run_workload``).  Lazy exports, as in the reference: the
OSD imports ``loadgen.stats`` at construction, and that import must not
drag the swarm -> librados -> osd import chain back in.
"""

_EXPORTS = {
    "WorkloadSpec": ".spec",
    "Op": ".spec",
    "payload_for": ".spec",
    "LatencyHistogram": ".histogram",
    "SimCluster": ".cluster",
    "ClientSwarm": ".swarm",
    "PhaseResult": ".swarm",
    "run_workload": ".driver",
    "deterministic_view": ".driver",
    "degradation_ratios": ".driver",
    "cluster_gates": ".driver",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
