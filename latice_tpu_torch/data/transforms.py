"""Pattern preprocessing as whole-stack numpy ops, on the host.

The port's copy of ``latice_tpu.data.transforms`` (the reference's PIL
pipeline, latice/data_module.py:17-33, as vectorized ops):

* grayscale: a trailing RGB axis is reduced with the ITU-R 601 luma
  weights PIL uses for ``Grayscale()``;
* center crop to ``image_size`` with torchvision CenterCrop's coordinates;
* dtype: unsigned integers scale by their dtype max (1/255 for uint8, like
  ``ToTensor``), other integers by 1/255, floats pass through unscaled.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "to_grayscale",
    "center_crop",
    "default_transform",
    "create_default_transform",
    "prepare_patterns",
]

_LUMA = np.asarray([0.299, 0.587, 0.114], dtype=np.float32)


def to_grayscale(patterns: np.ndarray) -> np.ndarray:
    """Reduce a trailing RGB channel axis if present; pass through otherwise."""
    if patterns.ndim >= 3 and patterns.shape[-1] == 3:
        return patterns.astype(np.float32) @ _LUMA
    return patterns


def center_crop(patterns: np.ndarray, image_size: tuple[int, int]) -> np.ndarray:
    """Center-crop the trailing (H, W) axes to ``image_size``.

    torchvision CenterCrop's coordinates, ``int(round(margin / 2))`` with
    round-half-to-even, and zero padding when the target exceeds the input.
    """
    th, tw = int(image_size[0]), int(image_size[1])
    h, w = patterns.shape[-2], patterns.shape[-1]
    if th > h or tw > w:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        pad = [(0, 0)] * (patterns.ndim - 2)
        pad += [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
        patterns = np.pad(patterns, pad)
        h, w = patterns.shape[-2], patterns.shape[-1]
    top = max(int(round((h - th) / 2.0)), 0)
    left = max(int(round((w - tw) / 2.0)), 0)
    return patterns[..., top : top + th, left : left + tw]


def _int_scale(dtype) -> np.float32:
    """[0, 1] normalization factor of a dtype: unsigned integers by their
    max, other integers by 1/255, floats by 1."""
    if np.issubdtype(dtype, np.unsignedinteger):
        return np.float32(1.0 / np.iinfo(dtype).max)
    if np.issubdtype(dtype, np.integer):
        return np.float32(1.0 / 255.0)
    return np.float32(1.0)


def default_transform(
    patterns: np.ndarray, image_size: tuple[int, int] = (128, 128)
) -> np.ndarray:
    """Gray, crop, float32, scale; returns float32 with a trailing channel
    axis of 1."""
    x = np.asarray(patterns)
    scale = _int_scale(x.dtype)  # from the original dtype: to_grayscale promotes
    x = to_grayscale(x)
    x = center_crop(x, image_size).astype(np.float32) * scale
    return x[..., None]


def prepare_patterns(
    patterns: np.ndarray, image_size: tuple[int, int] = (128, 128)
) -> np.ndarray:
    """Normalize a query stack to ``(N, H, W)``, keeping uint8 as uint8.

    uint8 stacks stay uint8 (a center crop is a slice) and are divided by
    255 on the device; other integers are scaled here; floats pass through.
    Accepts ``(H, W)``, ``(N, H, W)``, ``(N, H, W, 1)`` or ``(N, H, W, 3)``.
    """
    x = np.asarray(patterns)
    if x.ndim == 2:
        x = x[None]
    if x.ndim == 4 and x.shape[-1] == 3:
        x = to_grayscale(x.astype(np.float32) * _int_scale(x.dtype))
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.ndim != 3:
        raise ValueError(f"expected (N, H, W[, 1|3]) patterns, got {x.shape}")
    if x.dtype == np.uint8:
        if x.shape[1:] != tuple(image_size):
            x = center_crop(x, image_size)
        return x
    if np.issubdtype(x.dtype, np.integer):
        x = x.astype(np.float32) * _int_scale(x.dtype)
    if x.shape[1:] != tuple(image_size):
        x = default_transform(x, image_size)[..., 0]
    return np.ascontiguousarray(x, dtype=np.float32)


def create_default_transform(image_size: tuple[int, int]):
    """`default_transform` at ``image_size`` as a one-argument callable, the
    reference's factory name (data_module.py:17-33)."""

    def transform(patterns: np.ndarray) -> np.ndarray:
        return default_transform(patterns, image_size)

    return transform
