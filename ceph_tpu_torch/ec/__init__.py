"""Erasure-code layer: interface, base class, plugin registry, plugins."""

from .interface import ErasureCodeInterface, ErasureCodeProfile  # noqa: F401
from .base import ErasureCode, SIMD_ALIGN  # noqa: F401
from .registry import ErasureCodePluginRegistry, instance as registry  # noqa: F401
