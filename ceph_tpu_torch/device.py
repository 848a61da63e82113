"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the CPU.

    Asking for CUDA on a machine without a usable card raises instead of
    carrying on on the CPU: only an explicit ``device="cpu"`` selects the
    plain PyTorch versions of the kernels.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def launch_counts() -> dict[str, int]:
    """This process's launches of each hand-written kernel (K1-K6), as each
    wrapper counts them where it launches its kernel."""
    from .crush import rule_lanes, vectorized
    from .ops import crc32c_batch, gf2kernels
    return {**gf2kernels.LAUNCHES, **crc32c_batch.LAUNCHES,
            **vectorized.LAUNCHES, **rule_lanes.LAUNCHES}
