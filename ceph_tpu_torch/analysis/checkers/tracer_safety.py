"""tracer-safety: omitted in the port, with its reason.

The reference's rule (``ceph_tpu/analysis/checkers/tracer_safety.py``)
finds host syncs and Python branches on traced values inside code that
``jax.jit`` or ``pallas_call`` traces.  The port traces no Python: its
kernels are CUDA C++ that nvcc compiles, and no function of it runs under
``torch.compile``, ``torch.jit`` or a CUDA graph capture, so there is no
traced scope for the rule to look in.  A host sync in the Python around
a launch is ``device-path-host-sync``'s.
"""

from __future__ import annotations

from ..registry import omit

omit("tracer-safety",
     "the port traces no Python: its kernels are CUDA C++ built by nvcc, "
     "and nothing runs under torch.compile, torch.jit or a CUDA graph "
     "capture; host syncs around a launch are device-path-host-sync's")
