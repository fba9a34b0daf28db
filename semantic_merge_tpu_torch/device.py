"""Device selection for the port's entry points.

The counterpart of the JAX package's ``utils/jaxenv.py``: the port runs
on a CUDA card. The CPU is used only when the caller asks for it by
name (the tests do), never as a silent fallback.
"""
from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """No CUDA device, and the caller did not ask for the CPU."""


def resolve_device(name: str | None = None) -> torch.device:
    """``None`` or ``"cuda[:N]"`` → the CUDA device, raising when CUDA is
    absent; ``"cpu"`` → the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    dev = torch.device(name or "cuda")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; the port runs on an NVIDIA GPU "
            "(pass --device cpu / device='cpu' to run on the CPU)")
    return dev
