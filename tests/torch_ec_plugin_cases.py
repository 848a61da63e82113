"""The port's plugin registry for the CPU tests: every codec it builds is
bound to ``device="cpu"`` (the device plugins' plain versions; the host
plugins ignore the device), so the reference's plugin cases run on the port
as written."""

from ceph_tpu_torch.ec import ErasureCodePluginRegistry


class CpuRegistry(ErasureCodePluginRegistry):
    def factory(self, plugin_name, profile, device="cpu"):
        return super().factory(plugin_name, profile, device=device)


_INSTANCE = CpuRegistry()


def registry() -> CpuRegistry:
    """The process-wide CPU registry (``ceph_tpu_torch.ec.registry``'s
    counterpart)."""
    return _INSTANCE
