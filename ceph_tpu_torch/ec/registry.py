"""Erasure-code plugin registry.

Plugins are named factories resolved at first use by importing
``ceph_tpu_torch.ec.plugins.<name>`` and running its entry point; the
profile-echo check is kept.  The device a codec runs on travels beside
the profile (``factory(name, profile, device=...)``), never inside it: a
profile is what the OSDMap carries to every daemon and client.  The
plugins that run on a device (``cuda``, ``lrc``, ``pmsr``) take it; the
host plugins (``isa``, ``jerasure``, ``shec``, ``clay``, ``example``)
ignore it.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

from .interface import ErasureCodeInterface, ErasureCodeProfile

PLUGIN_API_VERSION = 1

# module attribute every plugin module must expose
ENTRY_POINT = "__erasure_code_init__"

DEFAULT_PLUGIN_PACKAGE = "ceph_tpu_torch.ec.plugins"


class ErasureCodePlugin:
    """A named factory."""

    def __init__(self, factory: Callable[..., ErasureCodeInterface],
                 api_version: int = PLUGIN_API_VERSION) -> None:
        self.api_version = api_version
        self._factory = factory

    def factory(self, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        """``self._factory(profile, device)``: ``device`` as for
        ``ErasureCodePluginRegistry.factory``."""
        codec = self._factory(profile, device)
        codec.init(profile)
        return codec


class ErasureCodePluginRegistry:
    def __init__(self) -> None:
        # reentrant: load() holds it while the plugin entry point calls add()
        self._lock = threading.RLock()
        self._plugins: dict[str, ErasureCodePlugin] = {}

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ValueError(f"plugin {name} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        return self._plugins.get(name)

    def load(self, plugin_name: str) -> ErasureCodePlugin:
        """Import ``ceph_tpu_torch.ec.plugins.<name>`` and run its entry point."""
        with self._lock:
            if plugin_name in self._plugins:
                return self._plugins[plugin_name]
            try:
                module = importlib.import_module(
                    f"{DEFAULT_PLUGIN_PACKAGE}.{plugin_name}")
            except ModuleNotFoundError as e:
                raise FileNotFoundError(
                    f"erasure-code plugin {plugin_name}: {e}") from e
            entry = getattr(module, ENTRY_POINT, None)
            if entry is None:
                raise ImportError(
                    f"erasure-code plugin {plugin_name}: missing entry point "
                    f"{ENTRY_POINT}")
            entry(self, plugin_name)
            plugin = self._plugins.get(plugin_name)
            if plugin is None:
                raise ImportError(
                    f"erasure-code plugin {plugin_name}: entry point did not "
                    f"register the plugin")
            if plugin.api_version != PLUGIN_API_VERSION:
                del self._plugins[plugin_name]
                raise ImportError(
                    f"erasure-code plugin {plugin_name}: api version "
                    f"{plugin.api_version} != {PLUGIN_API_VERSION}")
            return plugin

    def factory(
        self, plugin_name: str, profile: ErasureCodeProfile, device=None,
    ) -> ErasureCodeInterface:
        """Load (if needed) and instantiate a codec; verify the profile echo.

        ``device`` is where a device plugin's codec runs: CUDA unless the
        caller names the CPU (``None`` resolves to CUDA and raises
        without a card)."""
        plugin = self._plugins.get(plugin_name)
        if plugin is None:
            plugin = self.load(plugin_name)
        codec = plugin.factory(profile, device)
        echoed = codec.get_profile()
        for key, val in profile.items():
            if key not in echoed:
                raise ValueError(
                    f"plugin {plugin_name} profile lost key {key}={val}")
        return codec


_instance: ErasureCodePluginRegistry | None = None
_instance_lock = threading.Lock()


def instance() -> ErasureCodePluginRegistry:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = ErasureCodePluginRegistry()
    return _instance
