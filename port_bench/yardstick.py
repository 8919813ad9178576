"""Frozen arithmetic: the H100's peaks, model FLOPs from a configuration's
shapes, and the operations and bytes of the port's hand-written kernels.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit
(dense, no sparsity); every share of a peak is reported with the card's
power limit beside it (`power_limit_w`). The kernel counts are those of
``chip_smoke.py``'s bounds: K2f reads x and writes y (about 7 operations
an element) plus 8 bytes of statistics a plane; K2b reads x and g and
writes dx (about 10 operations) plus the statistics; K1 makes ``2D + 1``
operations a score and reads the queries and the dictionary once and
writes ``k`` (score, index) pairs of 12 bytes.
"""

from __future__ import annotations

import subprocess

__all__ = [
    "PEAK_BF16",
    "PEAK_BYTES",
    "PEAK_FP32",
    "bound_s",
    "decoder_flops",
    "encoder_flops",
    "k1_bound_s",
    "norm_bound_s",
    "norm_shapes",
    "power_limit_w",
    "train_flops",
]

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s


def bound_s(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)


def _conv(c_in: int, c_out: int, hw: int) -> float:
    return 2.0 * 9 * c_in * c_out * hw * hw


def _encoder_shapes(cfg: dict) -> list[tuple[int, int, int]]:
    """``(c_in, c_out, side)`` of each encoder convolution."""
    p, side, c = cfg["inplanes"], cfg["image_size"], 1
    out = []
    for width in [p, 2 * p] + [4 * p] * (cfg["n_stages"] - 2):
        out += [(c, width, side), (width, width, side)]
        c, side = width, side // 2
    return out


def encoder_flops(cfg: dict) -> float:
    """Model FLOPs of one pattern through the encoder and both heads (a
    multiply-add is two)."""
    flat = 4 * cfg["inplanes"] * cfg["bottleneck_hw"] ** 2
    return sum(_conv(*s) for s in _encoder_shapes(cfg)) + 2 * 2.0 * flat * cfg["latent_dim"]


def decoder_flops(cfg: dict) -> float:
    """Model FLOPs of one code through the decoder: each nearest 2x upsample
    followed by a 3x3 transposed convolution at the upsampled size, as the
    architecture defines it (the port's folded upsample does fewer)."""
    p, side = cfg["inplanes"], cfg["bottleneck_hw"]
    flops = 2.0 * cfg["latent_dim"] * 4 * p * side * side
    c = 4 * p
    for c1, c2 in [(4 * p, 4 * p)] * (cfg["n_stages"] - 3) + [(4 * p, 2 * p), (2 * p, p)]:
        side *= 2
        flops += _conv(c, c1, side) + _conv(c1, c2, side)
        c = c2
    side *= 2
    return flops + _conv(c, p, side) + _conv(p, 1, side)


def train_flops(cfg: dict) -> float:
    """Model FLOPs of one training row: forward plus backward, three times
    the encoder-and-decoder forward."""
    return 3.0 * (encoder_flops(cfg) + decoder_flops(cfg))


def norm_shapes(cfg: dict, train: bool) -> list[tuple[int, int]]:
    """``(channels, side)`` of each InstanceNorm + LeakyReLU the model runs:
    the encoder's two per stage and, in training, the decoder's."""
    shapes = [(c_out, side) for _, c_out, side in _encoder_shapes(cfg)]
    if train:
        p, side = cfg["inplanes"], cfg["bottleneck_hw"]
        for c1, c2 in [(4 * p, 4 * p)] * (cfg["n_stages"] - 3) + [(4 * p, 2 * p), (2 * p, p)]:
            side *= 2
            shapes += [(c1, side), (c2, side)]
        shapes.append((p, side * 2))
    return shapes


def norm_bound_s(cfg: dict, batch: int, train: bool, backward: bool, elem_bytes: int = 2) -> float:
    """The summed bound of one batch's K2f (or, with ``backward``, K2b)
    launches, each launch bounded on its own."""
    total = 0.0
    for c, side in norm_shapes(cfg, train):
        n = float(batch * c * side * side)
        stats = 8.0 * batch * c
        if backward:
            total += bound_s(3.0 * elem_bytes * n + stats, 10.0 * n)
        else:
            total += bound_s(2.0 * elem_bytes * n + stats, 7.0 * n)
    return total


def k1_bound_s(batch: int, rows: int, dim: int, k: int) -> float:
    """Bound of one K1 launch over ``rows`` f32 dictionary rows."""
    n_bytes = 4.0 * (batch * dim + rows * dim) + 12.0 * batch * k
    return bound_s(n_bytes, (2.0 * dim + 1.0) * batch * rows)


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or None where it is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
