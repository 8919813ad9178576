"""Device selection for the port's entry points, and the f32 convolution and
matmul scopes."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32_matmul", "no_onednn", "no_tf32", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.

    A CUDA device that is asked for and absent raises; an entry point never
    carries on silently on the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 inside the block.

    ``torch.backends.cudnn.allow_tf32`` (True by default) is False inside
    and restored on exit; every other cuDNN setting is left as it is.
    ``torch.backends.cudnn.flags(allow_tf32=False)`` is not the same: its
    other arguments default to ``enabled=False``, which switches cuDNN off.
    The flag is process-wide, so callers that run concurrently serialise
    around the block (`serve.IndexService` holds its lock).
    """
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def no_onednn():
    """ATen's own CPU convolution kernels inside the block, not oneDNN's.

    oneDNN's strided transposed convolution blocks its work over the batch,
    so one row's output moves by float32 rounding with the rows beside it
    (a masked pad row then changes the real rows' gradients); ATen's kernel
    computes each row alone, as oneDNN's stride-1 kernels do.
    ``torch.backends.mkldnn.enabled`` is False inside and restored on exit.
    Process-wide, like `no_tf32`.
    """
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matrix products in full float32 inside the block.

    ``torch.set_float32_matmul_precision("high")`` (or
    ``torch.backends.cuda.matmul.allow_tf32 = True``) lets cuBLAS multiply
    f32 in TF32, whose 10-bit mantissa moves the renderer's band edges.
    Inside the block the precision is "highest"; on exit the caller's
    setting comes back. At PyTorch's default ("highest") nothing is touched.
    cuDNN's flag is left alone (`no_tf32` scopes that). Process-wide, like
    `no_tf32`.
    """
    saved = torch.get_float32_matmul_precision()
    if saved == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
