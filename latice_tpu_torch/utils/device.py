"""Device selection helpers, the port of ``latice_tpu.utils.device``.

The JAX helpers cascade TPU -> GPU -> CPU and pick the CPU by themselves
when nothing else is there. The port does not: `get_device` returns the
CUDA device and raises without one unless the caller asks for the CPU, as
every entry point of the port does (`device.resolve_device`).
"""

from __future__ import annotations

import torch

from latice_tpu_torch.device import resolve_device

__all__ = ["get_device", "get_platform"]


def get_platform() -> str:
    """The best platform present, in the JAX package's names: ``"gpu"``
    when CUDA is available, else ``"cpu"``."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def get_device(preferred: str | torch.device | None = None) -> torch.device:
    """The CUDA device, or ``preferred`` when given (``"cpu"`` for the CPU;
    ``"gpu"`` is read as ``"cuda"``). A CUDA device that is absent raises;
    unlike the JAX helper this never falls back to the CPU."""
    if preferred == "gpu":
        preferred = "cuda"
    return resolve_device(preferred)
