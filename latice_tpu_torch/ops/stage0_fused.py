"""The VAE encoder's stage 0, fused (K3): a CUDA kernel and its plain twin.

Replaces ``latice_tpu/ops/stage0_fused.py:stage0_fused`` (body ``_kernel``)
and its helper ``fused_stage0_apply``. Stage 0 is the encoder's first two
blocks and their pool: Conv3x3(1→C) + bias → InstanceNorm → LeakyReLU(0.02)
→ bf16 → Conv3x3(C→C) + bias → InstanceNorm → LeakyReLU → bf16 → 2×2
max-pool. The numerics are the TPU kernel's: x, w1 and w2 rounded to bf16,
products exact in f32 and summed in f32, biases added after the taps, f32
statistics with ``var = max(E[v²] - mean², 0)``, y1 rounded to bf16 before
conv2, and conv2's SAME padding made of zeros of the normalized y1.

The kernel is ``csrc/stage0_fused.cu``; its source note says what bounds it
and how it is laid out. The TPU kernel's 4-image lane packing
(``pack_weights``, the batch-divides-by-pack rule) is a layout for the TPU's
128 lanes and has no counterpart here.

`stage0_fused` launches the kernel on a CUDA tensor and runs
`stage0_fused_reference` on a CPU tensor; nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from latice_tpu_torch.ops import _build
from latice_tpu_torch.ops.fused_norm import instance_norm_leaky_relu_plain

__all__ = ["fused_stage0_apply", "stage0_fused", "stage0_fused_reference"]

_CHANNELS = (16, 32, 64)  # the kernel's instantiations
_TILE = 16  # output pixels per tile side, as kTile in the source


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, as float32."""
    return t.float().to(torch.bfloat16).float()


def stage0_fused_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.02,
) -> torch.Tensor:
    """The same function in plain torch: f32 convolutions of bf16-rounded
    operands (a product of two bf16 values is exact in f32), the fused
    norm's plain statistics, bf16 between the blocks and at the end, then
    the pool. Returns ``(B, C, H/2, W/2)`` bfloat16."""
    acc1 = F.conv2d(_bf16(x), _bf16(w1), b1.float(), padding=1)
    y1 = _bf16(instance_norm_leaky_relu_plain(acc1, eps, slope)[0])
    acc2 = F.conv2d(y1, _bf16(w2), b2.float(), padding=1)
    y2 = instance_norm_leaky_relu_plain(acc2, eps, slope)[0].to(torch.bfloat16)
    return F.max_pool2d(y2.float(), 2).to(torch.bfloat16)


def _check_cuda(x, w1, b1, w2, b2) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"stage0_fused: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"stage0_fused takes (B, 1, H, W) images, got {tuple(x.shape)}")
    c = w1.shape[0]
    shapes = {"w1": (c, 1, 3, 3), "b1": (c,), "w2": (c, c, 3, 3), "b2": (c,)}
    for name, t in zip(shapes, (w1, b1, w2, b2)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"stage0_fused: {name} is {tuple(t.shape)}, want {shapes[name]}")
    if c not in _CHANNELS:
        raise ValueError(f"stage0_fused takes C in {_CHANNELS}, got {c}")
    h, w = x.shape[2:]
    if h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"stage0_fused takes even H and W, got {h}x{w}")
    for t in (x, w1, b1, w2, b2):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"stage0_fused takes float32 tensors on one device, got {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("stage0_fused takes contiguous tensors")


def stage0_fused(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.02,
) -> torch.Tensor:
    """Stage 0 of ``(B, 1, H, W)`` float32 images (uint8 already divided by
    255) with OIHW conv weights ``w1 (C, 1, 3, 3)``, ``w2 (C, C, 3, 3)`` and
    biases ``(C,)``; returns ``(B, C, H/2, W/2)`` bfloat16.

    On a CUDA tensor this launches ``csrc/stage0_fused.cu`` (C of 16, 32 or
    64, even H and W) and adds one to ``stage0_fused.launches``; on a CPU
    tensor it runs `stage0_fused_reference`.
    """
    if x.device.type == "cpu":
        return stage0_fused_reference(x, w1, b1, w2, b2, eps, slope)
    _check_cuda(x, w1, b1, w2, b2)
    b, _, h, w = x.shape
    c = w1.shape[0]
    dev = x.device
    out = torch.empty((b, c, h // 2, w // 2), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    tiles = -(-h // _TILE) * -(-w // _TILE)
    w2t = w2.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()  # [ky][kx][co][ci]
    stats1 = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    acc2 = torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
    part = torch.empty((b, tiles, c, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.latice_stage0_fused(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
            stats1.data_ptr(), acc2.data_ptr(), part.data_ptr(), out.data_ptr(),
            b, c, h, w, eps, slope, stream,
        )
    _build.check(lib, code, "stage0_fused")
    stage0_fused.launches += 1
    return out


stage0_fused.launches = 0


def fused_stage0_apply(
    encoder: torch.nn.Module, x: torch.Tensor, eps: float = 1e-5, slope: float = 0.02
) -> torch.Tensor:
    """Stage 0 of ``(B, 1, H, W)`` images with the weights of the port's
    encoder: its blocks ``encoder[0]`` and ``encoder[1]`` (state-dict keys
    ``encoder.0.0`` and ``encoder.1.0``); ``encoder[3:]`` takes the result."""
    conv1, conv2 = encoder[0][0], encoder[1][0]
    return stage0_fused(x, conv1.weight, conv1.bias, conv2.weight, conv2.bias, eps, slope)


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage0_fused")
    fn = lib.latice_stage0_fused
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, p]
        fn.restype = i
    return lib
