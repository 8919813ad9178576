"""Fused InstanceNorm + LeakyReLU, forward and backward: CUDA kernels and
their plain twins, joined in one autograd Function.

Replaces ``latice_tpu/ops/fused_norm.py:instance_norm_leaky_relu``: its
forward kernel ``_fwd_kernel`` (K2f) and its backward ``_bwd_kernel`` (K2b).
Both kernels are in ``csrc/fused_norm.cu``; its source note says what
bounds them on the card and how they are laid out. They take float32 or
bfloat16 tensors and keep every statistic in float32. The forward also
writes channels_last, from a channels_last or an NCHW input, the layout of
the encoder on the card under bfloat16 autocast, through a kernel of its
own (one thread-block cluster per image or group of its channels;
`_nhwc_plan` sizes it).

`instance_norm_leaky_relu` and `instance_norm_leaky_relu_backward` run
their kernel on a CUDA tensor and their plain version on a CPU tensor.
Nothing falls back from one to the other: a CUDA input a kernel does not
take raises. `InstanceNormLeakyReLUFunction` wraps the two as the
forward and backward of one differentiable op, on every device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from latice_tpu_torch.ops import _build
from latice_tpu_torch.utils.profiling import count

__all__ = [
    "InstanceNormLeakyReLUFunction",
    "instance_norm_leaky_relu",
    "instance_norm_leaky_relu_backward",
    "instance_norm_leaky_relu_backward_plain",
    "instance_norm_leaky_relu_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The NHWC forward's limits (``kNhwc*`` in csrc/fused_norm.cu) and aims,
# set by a sweep of groups and cluster sizes at the encoders' shapes on an
# H100 (PERF.md, K2f's NHWC row).
_NHWC_THREADS = 128  # most threads a CTA
_NHWC_CACHE_BYTES = 192 * 1024  # most a CTA caches; a larger slice is read twice
_NHWC_GROUP_BYTES = 128  # most bytes of a pixel's channel group
_NHWC_MIN_SEGMENT = 32  # fewest bytes of a pixel's group once halved: one DRAM sector
_NHWC_SLICE_BYTES = 32 * 1024  # a CTA's slice, aimed at
_NHWC_MAX_SLICE_BYTES = 64 * 1024  # and at most, where the group can halve: with the
#                                    kernel's 10 KB of sums, three CTAs fit an SM
_NHWC_MAX_CLUSTER = 16  # the most an H100 takes (above 8, non-portable)


def _is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a channels_last tensor that is not also contiguous
    in NCHW (a one-channel or one-pixel batch is both, and stays NCHW)."""
    return x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)


class NhwcPlan(NamedTuple):
    """How the NHWC forward covers a ``(B, C, H, W)`` channels_last tensor:
    one cluster of ``cluster`` CTAs per image and group of ``group``
    channels, each CTA ``rows`` pixels (the last the rest) with
    ``threads`` threads; ``cached``: the CTA keeps its slice in shared
    memory (else it reads x twice); ``vec``: 16-byte chunks of channels."""

    group: int
    cluster: int
    rows: int
    threads: int
    cached: bool
    vec: bool


@functools.lru_cache(maxsize=256)  # a model's few shapes, planned once each
def _nhwc_plan(c: int, hw: int, elem_bytes: int, vec: bool, nchw_in: bool = False) -> NhwcPlan:
    """The NHWC forward's plan for C channels over ``hw`` pixels (of an NCHW
    input with ``nchw_in``, whose slices are cached in whole chunks of
    pixels).

    The group is the largest divisor of C whose share of a pixel is at most
    `_NHWC_GROUP_BYTES`; the cluster as many CTAs as slices of
    `_NHWC_SLICE_BYTES` take, at most `_NHWC_MAX_CLUSTER`, one for the small
    late-stage images. Where that leaves slices above
    `_NHWC_MAX_SLICE_BYTES`, the group halves, down to a pixel's share of
    `_NHWC_MIN_SEGMENT` bytes.
    """
    per_chunk = 16 // elem_bytes if vec else 1
    most = min(c, max(per_chunk, _NHWC_GROUP_BYTES // elem_bytes))
    group = max(d for d in range(per_chunk, most + 1, per_chunk) if c % d == 0)

    def slices(group: int) -> int:
        return max(1, min(_NHWC_MAX_CLUSTER, hw, -(-hw * group * elem_bytes // _NHWC_SLICE_BYTES)))

    while (-(-hw // slices(group)) * group * elem_bytes > _NHWC_MAX_SLICE_BYTES
           and group % (2 * per_chunk) == 0 and group // 2 * elem_bytes >= _NHWC_MIN_SEGMENT):
        group //= 2
    step = per_chunk if nchw_in else 1
    rows = -(-hw // slices(group) // step) * step
    chunks = group // per_chunk
    return NhwcPlan(
        group=group, cluster=-(-hw // rows), rows=rows,
        threads=chunks * max(1, _NHWC_THREADS // chunks),
        cached=rows * group * elem_bytes <= _NHWC_CACHE_BYTES, vec=vec,
    )


def _out_format(x: torch.Tensor, memory_format: torch.memory_format | None):
    """The memory format of ``y``: ``memory_format``, else x's."""
    if memory_format is not None:
        return memory_format
    return torch.channels_last if _is_channels_last(x) else torch.contiguous_format


def instance_norm_leaky_relu_plain(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02,
    memory_format: torch.memory_format | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm(affine=False) + LeakyReLU over NCHW, in plain torch.

    One-pass statistics in f32: ``var = max(E[x²] - E[x]², 0)``, torch's
    defaults (biased variance, eps 1e-5) and slope 0.02. Returns ``(y,
    mean, rstd)``: ``y`` in x's dtype, ``mean`` and ``rstd`` f32 of shape
    ``(B, C)``. A channels_last ``x`` gives its NCHW copy's numbers. ``y``
    is in ``memory_format``, by default x's (channels_last or NCHW).
    """
    memory_format = _out_format(x, memory_format)
    channels_last = _is_channels_last(x)
    x32 = x.float().contiguous() if channels_last else x.float()
    mean = x32.mean(dim=(2, 3))
    ex2 = (x32 * x32).mean(dim=(2, 3))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[..., None, None]) * rstd[..., None, None]
    y = torch.where(y >= 0, y, negative_slope * y).to(x.dtype)
    return y.contiguous(memory_format=memory_format), mean, rstd


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


def _check_cuda(name: str, *tensors: torch.Tensor,
                memory_format: torch.memory_format = torch.contiguous_format) -> None:
    """Raise unless every tensor is a tensor of one kernel dtype on the
    first tensor's CUDA device, contiguous in ``memory_format``, the first
    of shape (B, C, H, W)."""
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
        if not t.is_contiguous(memory_format=memory_format):
            raise ValueError(f"{name} takes contiguous tensors")


def instance_norm_leaky_relu(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.02,
    memory_format: torch.memory_format | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused InstanceNorm + LeakyReLU of a ``(B, C, H, W)`` float32 or
    bfloat16 tensor, contiguous in NCHW or in channels_last; returns ``(y,
    mean, rstd)`` like the plain version, ``y`` in ``memory_format``, by
    default x's. A channels_last ``x`` takes a channels_last ``y``.

    On a CUDA tensor this launches a forward kernel of
    ``csrc/fused_norm.cu``, the NHWC one for a channels_last ``y`` (which
    also adds one to the program counter ``encoder.nhwc_norms``), and adds
    one to ``instance_norm_leaky_relu.launches``; on a CPU tensor it runs
    `instance_norm_leaky_relu_plain`.
    """
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_plain(x, eps, negative_slope, memory_format)
    channels_last = _is_channels_last(x)
    _check_cuda("instance_norm_leaky_relu", x, memory_format=(
        torch.channels_last if channels_last else torch.contiguous_format))
    nhwc = _out_format(x, memory_format) == torch.channels_last
    if channels_last and not nhwc:
        raise ValueError("instance_norm_leaky_relu: a channels_last x takes a channels_last y")
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last) if nhwc else torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if nhwc:
            size, nchw_in = x.element_size(), not channels_last
            per_chunk = 16 // size
            vec = (c % per_chunk == 0 and (h * w % per_chunk == 0 or not nchw_in)
                   and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
            plan = _nhwc_plan(c, h * w, size, vec, nchw_in)
            code = lib.latice_instance_norm_lrelu_fwd_nhwc(
                x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, c, h * w,
                *(int(v) for v in plan), int(nchw_in), eps, negative_slope,
                _DTYPE_CODES[x.dtype], stream,
            )
        else:
            code = lib.latice_instance_norm_lrelu_fwd(
                x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                b * c, h * w, eps, negative_slope, _DTYPE_CODES[x.dtype], stream,
            )
    _build.check(lib, code, "instance_norm_leaky_relu")
    instance_norm_leaky_relu.launches += 1
    if nhwc:
        count("encoder.nhwc_norms")
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

    ``InstanceNormLeakyReLUFunction.apply(x, eps, negative_slope[,
    memory_format])`` returns ``y``, in ``memory_format`` (by default
    x's). The forward marks ``x``, ``mean`` and ``rstd`` for the backward,
    as the Pallas rule keeps its residuals; under ``torch.no_grad()`` or
    ``torch.inference_mode()`` autograd records no graph and drops them, so
    serving holds nothing. The backward hands ``x`` and the output
    gradient, contiguous in NCHW and the gradient in x's dtype, to
    `instance_norm_leaky_relu_backward` and returns a new tensor: it never
    writes into the incoming gradient's buffer.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, negative_slope: float,
                memory_format: torch.memory_format | None = None) -> torch.Tensor:
        y, mean, rstd = instance_norm_leaky_relu(x, eps, negative_slope, memory_format)
        ctx.negative_slope = negative_slope
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, mean, rstd = ctx.saved_tensors
        x = x.contiguous()
        g = g.to(x.dtype).contiguous()
        dx = instance_norm_leaky_relu_backward(x, mean, rstd, g, ctx.negative_slope)
        return dx, None, None, None


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
        nhwc = lib.latice_instance_norm_lrelu_fwd_nhwc
        nhwc.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, i, p]
        nhwc.restype = i
    return lib
