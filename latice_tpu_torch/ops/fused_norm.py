"""Fused InstanceNorm + LeakyReLU, forward and backward: CUDA kernels and
their plain twins, joined in one autograd Function.

Replaces ``latice_tpu/ops/fused_norm.py:instance_norm_leaky_relu``: its
forward kernel ``_fwd_kernel`` (K2f) and its backward ``_bwd_kernel`` (K2b).
Both kernels are in ``csrc/fused_norm.cu``; its source note says what
bounds them on the card and how they are laid out. They take float32 or
bfloat16 tensors and keep every statistic in float32.

`instance_norm_leaky_relu` and `instance_norm_leaky_relu_backward` run
their kernel on a CUDA tensor and their plain version on a CPU tensor.
Nothing falls back from one to the other: a CUDA input a kernel does not
take raises. `InstanceNormLeakyReLUFunction` wraps the two as the
forward and backward of one differentiable op, on every device.
"""

from __future__ import annotations

import ctypes

import torch

from latice_tpu_torch.ops import _build

__all__ = [
    "InstanceNormLeakyReLUFunction",
    "instance_norm_leaky_relu",
    "instance_norm_leaky_relu_backward",
    "instance_norm_leaky_relu_backward_plain",
    "instance_norm_leaky_relu_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_leaky_relu_plain(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm(affine=False) + LeakyReLU over NCHW, in plain torch.

    One-pass statistics in f32: ``var = max(E[x²] - E[x]², 0)``, torch's
    defaults (biased variance, eps 1e-5) and slope 0.02. Returns ``(y,
    mean, rstd)``: ``y`` in x's dtype, ``mean`` and ``rstd`` f32 of shape
    ``(B, C)``.
    """
    x32 = x.float()
    mean = x32.mean(dim=(2, 3))
    ex2 = (x32 * x32).mean(dim=(2, 3))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[..., None, None]) * rstd[..., None, None]
    return torch.where(y >= 0, y, negative_slope * y).to(x.dtype), mean, rstd


def instance_norm_leaky_relu_backward_plain(
    x: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    g: torch.Tensor,
    negative_slope: float = 0.02,
) -> torch.Tensor:
    """The input gradient of `instance_norm_leaky_relu_plain`, in f32.

    ``y = (x - mean) * rstd`` is recomputed from x, then ``g_y = g *
    lrelu'(y)`` and ``dx = rstd * (g_y - mean(g_y) - y * mean(g_y * y))``.
    Returns dx in x's dtype.
    """
    m = mean.float()[..., None, None]
    r = rstd.float()[..., None, None]
    y = (x.float() - m) * r
    g32 = g.float()
    g_y = torch.where(y >= 0, g32, negative_slope * g32)
    mean_g = g_y.mean(dim=(2, 3), keepdim=True)
    mean_gy = (g_y * y).mean(dim=(2, 3), keepdim=True)
    return (r * (g_y - mean_g - y * mean_gy)).to(x.dtype)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous NCHW tensor of one kernel
    dtype on the first tensor's CUDA device."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} takes (B, C, H, W), got {tuple(x.shape)}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def instance_norm_leaky_relu(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused InstanceNorm + LeakyReLU of a contiguous ``(B, C, H, W)``
    float32 or bfloat16 tensor; returns ``(y, mean, rstd)`` like the plain
    version.

    On a CUDA tensor this launches the forward kernel of
    ``csrc/fused_norm.cu`` and adds one to
    ``instance_norm_leaky_relu.launches``; on a CPU tensor it runs
    `instance_norm_leaky_relu_plain`.
    """
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_plain(x, eps, negative_slope)
    _check_cuda("instance_norm_leaky_relu", x)
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
            b * c, h * w, eps, negative_slope, _DTYPE_CODES[x.dtype], stream,
        )
    _build.check(lib, code, "instance_norm_leaky_relu")
    instance_norm_leaky_relu.launches += 1
    return y, mean, rstd


instance_norm_leaky_relu.launches = 0


def instance_norm_leaky_relu_backward(
    x: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    g: torch.Tensor,
    negative_slope: float = 0.02,
) -> torch.Tensor:
    """The input gradient of `instance_norm_leaky_relu` at ``x`` for the
    output gradient ``g``, from the forward's ``mean`` and ``rstd``.

    ``x`` and ``g`` are contiguous ``(B, C, H, W)`` tensors of one dtype
    (float32 or bfloat16), ``mean`` and ``rstd`` f32 ``(B, C)``; ``dx`` is
    a new tensor in x's dtype. On a CUDA tensor this launches the backward
    kernel of ``csrc/fused_norm.cu`` and adds one to
    ``instance_norm_leaky_relu_backward.launches``; on a CPU tensor it runs
    `instance_norm_leaky_relu_backward_plain`.
    """
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_backward_plain(x, mean, rstd, g, negative_slope)
    _check_cuda("instance_norm_leaky_relu_backward", x, g, mean, rstd)
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(
            f"instance_norm_leaky_relu_backward: g is {g.dtype} {tuple(g.shape)}, "
            f"x is {x.dtype} {tuple(x.shape)}"
        )
    b, c, h, w = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (b, c):
            raise ValueError(
                f"instance_norm_leaky_relu_backward: {name} must be float32 {(b, c)}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.latice_instance_norm_lrelu_bwd(
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
            b * c, h * w, negative_slope, _DTYPE_CODES[x.dtype], stream,
        )
    _build.check(lib, code, "instance_norm_leaky_relu_backward")
    instance_norm_leaky_relu_backward.launches += 1
    return dx


instance_norm_leaky_relu_backward.launches = 0


class InstanceNormLeakyReLUFunction(torch.autograd.Function):
    """InstanceNorm + LeakyReLU with the fused forward and backward.

    ``InstanceNormLeakyReLUFunction.apply(x, eps, negative_slope)`` returns
    ``y``. The forward marks ``x``, ``mean`` and ``rstd`` for the backward,
    as the Pallas rule keeps its residuals; under ``torch.no_grad()`` or
    ``torch.inference_mode()`` autograd records no graph and drops them, so
    serving holds nothing. The backward hands the output gradient,
    contiguous and in x's dtype, to `instance_norm_leaky_relu_backward` and
    returns a new tensor: it never writes into the incoming gradient's
    buffer.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, negative_slope: float) -> torch.Tensor:
        y, mean, rstd = instance_norm_leaky_relu(x, eps, negative_slope)
        ctx.negative_slope = negative_slope
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, mean, rstd = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = instance_norm_leaky_relu_backward(x, mean, rstd, g, ctx.negative_slope)
        return dx, None, None


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_norm")
    fwd = lib.latice_instance_norm_lrelu_fwd
    if fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd.argtypes = [p, p, p, p, i, i, f, f, i, p]
        fwd.restype = i
        bwd = lib.latice_instance_norm_lrelu_bwd
        bwd.argtypes = [p, p, p, p, p, i, i, f, i, p]
        bwd.restype = i
    return lib
