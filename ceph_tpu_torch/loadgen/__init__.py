"""Cluster harness: the in-process cluster and the workload counters.

Port of ``ceph_tpu/loadgen/``'s ``stats`` (the process-wide "workload"
counter set the OSD adopts) and ``cluster`` (``SimCluster``: a monitor
and N OSDs in one process, with kill, revive and wait helpers).  Lazy
exports, as in the reference: the OSD imports ``loadgen.stats`` at
construction, and that import must not drag the OSD back in.
"""

_EXPORTS = {
    "SimCluster": ".cluster",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
