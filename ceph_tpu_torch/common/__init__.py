"""Shared host utilities: per-component performance counters."""
