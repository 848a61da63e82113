"""PyTorch/CUDA port of ``ceph_tpu``'s erasure-code stripe codec.

The package mirrors ``ceph_tpu``'s module names (``gf``, ``ec``, ``ops``,
``tools``) so each counterpart is easy to find.  It imports torch and
numpy and nothing of JAX or ``ceph_tpu``: the GF(2^8) tables, generator
matrices and codec plumbing it needs are its own copies.

Entry points (``TorchBackend``, ``ErasureCodeCuda``) run on the CUDA card
unless the caller passes ``device="cpu"``, which selects the plain PyTorch
versions of the kernels (what the CPU tests use).
"""

from .device import resolve_device  # noqa: F401
