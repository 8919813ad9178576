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
and how it is laid out. Its conv2 pass is persistent: `_plan` picks the
grid and names the tile, and `_work_items` lists each block's (image, tile)
items in the kernel's order. `_stage0_pool_first` is the plain function in
the kernel's own order (pool the f32 conv2 output, then normalize). The TPU
kernel's 4-image lane packing (``pack_weights``, the batch-divides-by-pack
rule) is a layout for the TPU's 128 lanes and has no counterpart here.

`stage0_fused` launches the kernel on a CUDA tensor and runs
`stage0_fused_reference` on a CPU tensor; nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from latice_tpu_torch.ops import _build
from latice_tpu_torch.ops.fused_norm import instance_norm_leaky_relu_plain

__all__ = ["fused_stage0_apply", "stage0_fused", "stage0_fused_reference"]

_CHANNELS = (16, 32, 64)  # the kernel's instantiations
_TILE_H, _TILE_W = 16, 32  # output pixels per conv2 tile, as kTileH, kTileW in the source
_BLOCKS_PER_SM = 2  # persistent conv2 blocks aimed at per SM
_SMEM_LIMIT = 232_448  # shared memory one block may use on an H100 (227 KB)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, as float32."""
    return t.float().to(torch.bfloat16).float()


def _conv2_input(x, w1, b1, w2, b2, eps, slope) -> torch.Tensor:
    """conv2 + b2 in f32 of the bf16-rounded y1."""
    acc1 = F.conv2d(_bf16(x), _bf16(w1), b1.float(), padding=1)
    y1 = _bf16(instance_norm_leaky_relu_plain(acc1, eps, slope)[0])
    return F.conv2d(y1, _bf16(w2), b2.float(), padding=1)


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
    acc2 = _conv2_input(x, w1, b1, w2, b2, eps, slope)
    y2 = instance_norm_leaky_relu_plain(acc2, eps, slope)[0].to(torch.bfloat16)
    return F.max_pool2d(y2.float(), 2).to(torch.bfloat16)


def _stage0_pool_first(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.02,
) -> torch.Tensor:
    """`stage0_fused_reference` in the kernel's order: the 2x2 max of the f32
    conv2 output first, then the normalization (statistics over every
    pixel), LeakyReLU and one bf16 rounding per output. Each of those steps
    is monotone non-decreasing, so this is bitwise equal to transforming
    every pixel and pooling after."""
    acc2 = _conv2_input(x, w1, b1, w2, b2, eps, slope)
    _, mean, rstd = instance_norm_leaky_relu_plain(acc2, eps, slope)
    y = (F.max_pool2d(acc2, 2) - mean[..., None, None]) * rstd[..., None, None]
    return torch.where(y >= 0, y, slope * y).to(torch.bfloat16)


def _smem_bytes(c: int) -> int:
    """Shared memory of one conv2 block at C=c, as ``Conv2Smem<C>::kBytes``:
    w2, w1 (16 x c) and the y1 halo tile (pitch c + 8) in bf16, two x
    windows, two (mean, rstd) tables, the cross-warp sums, and two buffers
    of pooled maxima per warpgroup."""
    halo = (_TILE_H + 2) * (_TILE_W + 2) * (c + 8) * 2
    windows = 2 * (_TILE_H + 4) * (_TILE_W + 4) * 4
    staged = 2 * 2 * c * (_TILE_W // 2) * 4
    return (9 * c * c * 2 + 16 * c * 2 + halo + windows + 2 * c * 2 * 4 + 8 * c * 2 * 4
            + staged)


def _tile_grid(h: int, w: int) -> tuple[int, int]:
    """(tile rows, tile columns) that cover an h x w image."""
    return -(-h // _TILE_H), -(-w // _TILE_W)


def _plan(b: int, h: int, w: int, c: int, sms: int) -> tuple[int, int, int]:
    """The conv2 pass's launch plan for ``b`` images of h x w at C=c on a
    card with ``sms`` SMs: ``(blocks, tile_h, tile_w)``. Up to
    `_BLOCKS_PER_SM` blocks per SM, as many as their shared memory lets
    stay resident, and never more blocks than (image, tile) items."""
    ty, tx = _tile_grid(h, w)
    per_sm = max(1, min(_BLOCKS_PER_SM, _SMEM_LIMIT // _smem_bytes(c)))
    return min(b * ty * tx, sms * per_sm), _TILE_H, _TILE_W


def _work_items(b: int, h: int, w: int, blocks: int) -> list[list[tuple[int, int, int]]]:
    """Each conv2 block's work items in the kernel's order, as (image, tile
    row origin, tile column origin): block k takes items k, k + blocks, ...
    of the (image, tile) items in image-major, row-major order."""
    ty, tx = _tile_grid(h, w)
    tiles = ty * tx
    return [
        [(i // tiles, (i % tiles) // tx * _TILE_H, (i % tiles) % tx * _TILE_W)
         for i in range(k, b * tiles, blocks)]
        for k in range(blocks)
    ]


def _canonical_w2(w2: torch.Tensor) -> torch.Tensor:
    """w2 (C, C, 3, 3) as bf16 in wgmma's canonical K-major layout, the
    kernel's shared layout: [ky*3+kx][ci/8][co/8][co%8][ci%8]."""
    c = w2.shape[0]
    t = w2.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(9, c // 8, 8, c // 8, 8)
    return t.permute(0, 1, 3, 4, 2).contiguous()


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
    blocks, tile_h, tile_w = _plan(b, h, w, c, _sm_count(dev))
    ty, tx = _tile_grid(h, w)
    w2c = _canonical_w2(w2)
    stats1 = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    pooled = torch.empty((b, c, h // 2, w // 2), dtype=torch.float32, device=dev)
    part = torch.empty((b, ty * tx, c, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.latice_stage0_fused(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2c.data_ptr(), b2.data_ptr(),
            stats1.data_ptr(), pooled.data_ptr(), part.data_ptr(), out.data_ptr(),
            b, c, h, w, blocks, tile_h, tile_w, eps, slope, stream,
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


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage0_fused")
    fn = lib.latice_stage0_fused
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
        fn.restype = i
        lib.latice_stage0_smem_bytes.argtypes = [i]
        lib.latice_stage0_smem_bytes.restype = i
    return lib
