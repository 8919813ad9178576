"""Detector geometry: pixel → scattering-direction map.

The port's own copy of ``latice_tpu.sim.geometry`` (host numpy). A gnomonic
model: the detector is a ``(H, W)`` grid of square pixels; the *pattern
center* is where the sample normal through the beam spot pierces the
detector plane, in fractional detector coordinates ``(pcx, pcy)``
(TSL-style: x rightward from the left edge, y upward from the BOTTOM edge,
both in units of detector width), and ``dd`` is the detector distance in
the same units. A pixel's unit direction in the detector frame is

    d = normalize( (col_frac - pcx) , (H/W - row_frac·(H/W) - pcy) , dd )

where ``row_frac`` grows downward from the top. z points from the sample
into the detector. Crystal plane normals are rotated into this frame by the
orientation quaternion, so band positions are the gnomonic projections of
the Kossel-cone traces.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["DetectorGeometry", "pixel_directions"]


@dataclasses.dataclass(frozen=True)
class DetectorGeometry:
    """EBSD detector description.

    Attributes:
        shape: ``(H, W)`` pixels.
        pcx / pcy: pattern center, fractions of detector width from the
            left edge / bottom edge (TSL-style).
        dd: sample→detector distance as a fraction of detector width.
            Smaller ``dd`` = wider angular capture (more bands).
        tilt: detector tilt about the horizontal (x) axis, degrees —
            positive tips the detector top away from the sample. Exactly
            equivalent to pre-rotating every orientation by the inverse
            tilt (pinned by test), provided so vendor geometries map
            directly instead of being folded into orientation conventions.
    """

    shape: tuple[int, int] = (128, 128)
    pcx: float = 0.5
    pcy: float = 0.5
    dd: float = 0.7
    tilt: float = 0.0

    def __post_init__(self):
        if self.dd <= 0:
            raise ValueError("detector distance dd must be positive")
        if len(self.shape) != 2 or min(self.shape) < 2:
            raise ValueError(f"bad detector shape {self.shape}")


def pixel_directions(geometry: DetectorGeometry) -> np.ndarray:
    """``(H, W, 3)`` unit scattering directions, detector frame (host numpy:
    computed once per geometry, shipped to device as a constant)."""
    h, w = geometry.shape
    col = (np.arange(w, dtype=np.float64) + 0.5) / w  # x: left→right
    # y grows upward while the row index grows downward; pcy is measured
    # from the detector's bottom edge, in width units (square pixels).
    dist_bottom = (h - (np.arange(h, dtype=np.float64) + 0.5)) / w
    x = np.broadcast_to(col[None, :] - geometry.pcx, (h, w))
    y = np.broadcast_to(dist_bottom[:, None] - geometry.pcy, (h, w))
    z = np.full((h, w), geometry.dd)
    d = np.stack([x, y, z], axis=-1)
    if geometry.tilt:
        t = math.radians(geometry.tilt)
        rot = np.array(
            [
                [1.0, 0.0, 0.0],
                [0.0, math.cos(t), -math.sin(t)],
                [0.0, math.sin(t), math.cos(t)],
            ]
        )
        d = d @ rot.T
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
