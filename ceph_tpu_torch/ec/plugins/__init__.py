"""Builtin erasure-code plugins (one module per plugin, loaded by name)."""
