"""Fused InstanceNorm + LeakyReLU forward: a CUDA kernel and its plain twin.

Replaces ``latice_tpu/ops/fused_norm.py:instance_norm_leaky_relu`` (the
forward kernel ``_fwd_kernel``). The kernel is ``csrc/fused_norm.cu``; its
source note says what bounds it on the card and how it is laid out.

`instance_norm_leaky_relu` runs the kernel on a CUDA tensor and the plain
version `instance_norm_leaky_relu_plain` on a CPU tensor. Nothing falls
back from one to the other: a CUDA input the kernel does not take raises.
The backward kernel comes with the training path.
"""

from __future__ import annotations

import ctypes

import torch

from latice_tpu_torch.ops import _build

__all__ = ["instance_norm_leaky_relu", "instance_norm_leaky_relu_plain"]


def instance_norm_leaky_relu_plain(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm(affine=False) + LeakyReLU over NCHW, in plain torch.

    One-pass statistics in f32: ``var = max(E[x²] - E[x]², 0)``, torch's
    defaults (biased variance, eps 1e-5) and slope 0.02. Returns ``(y,
    mean, rstd)`` with ``mean`` and ``rstd`` of shape ``(B, C)``.
    """
    mean = x.mean(dim=(2, 3))
    ex2 = (x * x).mean(dim=(2, 3))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean[..., None, None]) * rstd[..., None, None]
    return torch.where(y >= 0, y, negative_slope * y), mean, rstd


def instance_norm_leaky_relu(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused InstanceNorm + LeakyReLU of a contiguous ``(B, C, H, W)`` f32
    tensor; returns ``(y, mean, rstd)`` like the plain version.

    On a CUDA tensor this launches ``csrc/fused_norm.cu`` and adds one to
    ``instance_norm_leaky_relu.launches``; on a CPU tensor it runs
    `instance_norm_leaky_relu_plain`.
    """
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_plain(x, eps, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_leaky_relu: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"instance_norm_leaky_relu takes float32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_leaky_relu takes (B, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_leaky_relu takes a contiguous tensor")
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.latice_instance_norm_lrelu_fwd(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            b * c, h * w, eps, negative_slope, stream,
        )
    _build.check(lib, code, "instance_norm_leaky_relu")
    instance_norm_leaky_relu.launches += 1
    return y, mean, rstd


instance_norm_leaky_relu.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_norm")
    fn = lib.latice_instance_norm_lrelu_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
