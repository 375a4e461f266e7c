"""Where the port runs: the one rule every entry point uses to turn a
device argument into a `torch.device`."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means the GPU, and raises when there is none; the CPU is
    used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
