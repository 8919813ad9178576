"""IPF (inverse pole figure) color key generation — vectorized, all systems
(host numpy; the port's own copy of ``latice_tpu/utils/colorkey.py``).

Rebuild of the reference's per-vector ColorKeyGenerator
(latice/utils/colorkey.py:21-130) as batch numpy ops: all symmetry images
(rotations x inversion) of every zone axis are generated at once and the
first equivalent inside the group's fundamental sector is selected in the
same iteration order the reference uses, so cubic colors match exactly.

The reference is cubic-only (eta in [0, 45deg], chi in [0, acos(1/sqrt(3))]);
``group`` extends the same construction to every proper rotation point group
(multi-phase maps, BASELINE config 5): each Laue class gets its azimuthal
lune between adjacent mirror lines (see IPF_SECTORS; chi_max = 90deg except
the cubic classes' acos(1/sqrt(3))) and the same r/g/b parametrization over
the normalized (eta, chi) sector coordinates.
"""

from __future__ import annotations

from math import acos, pi

import numpy as np
from numpy.typing import NDArray

from latice_tpu_torch.crystal.symmetry import (
    K_180_OVER_PI,
    PI_OVER_180,
    SQRT3_INV,
    USE_INVERSION,
    apply_symmetry_to_axes,
)

__all__ = ["ColorKeyGenerator", "IPF_SECTORS"]

_CHI_MAX_CUBIC_RAD = acos(SQRT3_INV)
_ETA_MAX_RAD = 45.0 * PI_OVER_180

# Fundamental IPF sector per proper point group (Laue-class convention):
# (eta_min_rad, eta_max_rad, chi_max_rad). Azimuthal lunes sit between
# adjacent mirror lines of the Laue class; with this package's two-fold axes
# at (180/n)*k from x, dihedral mirror lines fall at 90 + (180/n)*k degrees —
# which includes 0 for even n but puts the trigonal "32" lune at [30, 90].
IPF_SECTORS: dict[str, tuple[float, float, float]] = {
    "1": (0.0, 2 * pi, pi / 2),  # -1: upper hemisphere
    "2": (0.0, pi, pi / 2),  # 2/m
    "222": (0.0, pi / 2, pi / 2),  # mmm
    "3": (0.0, 2 * pi / 3, pi / 2),  # -3
    "32": (pi / 6, pi / 2, pi / 2),  # -3m
    "4": (0.0, pi / 2, pi / 2),  # 4/m
    "422": (0.0, pi / 4, pi / 2),  # 4/mmm
    "6": (0.0, pi / 3, pi / 2),  # 6/m
    "622": (0.0, pi / 6, pi / 2),  # 6/mmm
    # m-3: the box is further cut to the true fundamental quadrilateral
    # [001]-[101]-[111]-[011] (z >= max(x, y)) in generate_ipf_colors — the
    # box alone over-covers 4pi/24 sr and would give first-match-order-
    # dependent colors to orbits with two in-box images.
    "23": (0.0, pi / 2, _CHI_MAX_CUBIC_RAD),
    "432": (0.0, _ETA_MAX_RAD, _CHI_MAX_CUBIC_RAD),  # m-3m (reference sector)
}


class ColorKeyGenerator:
    """Maps crystallographic directions to IPF RGB colors.

    Args:
        group: Proper point group of the crystal (`crystal.ROTATION_GROUPS`
            key). The default "432" reproduces the reference's cubic key
            bit-for-bit; other groups use their Laue-class sector.
    """

    def __init__(self, group: str = "432") -> None:
        if group not in IPF_SECTORS:
            raise ValueError(
                f"unknown point group {group!r}; choose from {sorted(IPF_SECTORS)}"
            )
        self.group = group
        self._eta_min_rad, self._eta_max_rad, self._chi_max_rad = IPF_SECTORS[
            group
        ]

    @staticmethod
    def in_unit_triangle(eta: float = 0, chi: float = 0) -> bool:
        """True when (eta, chi) radians lie in the standard cubic unit
        triangle (reference colorkey.py:30-42)."""
        return not (
            eta < 0 or eta > _ETA_MAX_RAD or chi < 0 or chi > _CHI_MAX_CUBIC_RAD
        )

    @staticmethod
    def drgb(a: int = 0, r: int | list[int] = 0, g: int = 0, b: int = 0) -> int:
        """Pack ARGB into a 32-bit int (reference colorkey.py:45-62)."""
        if isinstance(r, list) and len(r) == 3:
            g = int(round(r[1]))
            b = int(round(r[2]))
            r = int(round(r[0]))
        return ((a & 0xFF) << 24) | ((r & 0xFF) << 16) | ((g & 0xFF) << 8) | (b & 0xFF)

    def generate_ipf_color(self, zone_axis: NDArray | list[float]) -> list[int]:
        """IPF color of one direction as [r, g, b] in 0-255
        (reference colorkey.py:64-130)."""
        rgb = self.generate_ipf_colors(np.asarray(zone_axis, dtype=np.float64)[None])
        return [int(v) for v in rgb[0]]

    def generate_ipf_colors(self, zone_axes: NDArray) -> NDArray[np.int64]:
        """Vectorized IPF colors for ``(N, 3)`` directions -> ``(N, 3)`` uint8-range ints."""
        axes = np.asarray(zone_axes, dtype=np.float64)
        axes = axes / np.linalg.norm(axes, axis=-1, keepdims=True)

        # (N, S, 3) rotational images, then append the inverted set -> (N, 2S, 3)
        sym_axes = apply_symmetry_to_axes(axes, self.group)
        cands = np.concatenate([sym_axes, -sym_axes], axis=1)

        # Reference behavior: z<0 candidates are inverted in place when
        # USE_INVERSION, else skipped (colorkey.py:92-96).
        neg_z = cands[..., 2] < 0
        if USE_INVERSION:
            cands = np.where(neg_z[..., None], -cands, cands)
            usable = np.ones(cands.shape[:2], dtype=bool)
        else:
            usable = ~neg_z

        z = np.clip(cands[..., 2], -1.0, 1.0)
        chi = np.arccos(z)
        eta = np.arctan2(cands[..., 1], cands[..., 0])
        # Azimuth wrapped to [0, 2pi): equivalent to the reference's eta >= 0
        # test for the cubic sector, and required for lunes wider than pi.
        eta_w = np.mod(eta, 2 * pi)
        in_sector = (
            usable
            & (eta_w >= self._eta_min_rad)
            & (eta_w <= self._eta_max_rad)
            & (chi >= 0)
            & (chi <= self._chi_max_rad)
        )
        if self.group == "23":
            # True m-3 domain: z >= max(x, y), i.e. chi <= atan(1/max(cos
            # eta, sin eta)) — the great-circle arcs [101]->[111] (plane z=x)
            # and [111]->[011] (plane z=y). Exactly 4pi/24 sr, so every
            # orbit has one in-sector image and colors are order-independent.
            chi_cap = np.arctan2(1.0, np.maximum(np.cos(eta_w), np.sin(eta_w)))
            in_sector &= chi <= chi_cap + 1e-9

        # First in-sector candidate in reference iteration order; fall back
        # to the last candidate when none qualify (reference keeps whatever
        # eta/chi the loop ended with, colorkey.py:105-108).
        any_found = in_sector.any(axis=1)
        first = np.where(any_found, in_sector.argmax(axis=1), cands.shape[1] - 1)
        rows = np.arange(len(axes))
        chi_sel = chi[rows, first]

        if self.group == "23":
            # Normalize chi against the eta-dependent sector edge so the
            # full red->edge gradient spans the quadrilateral.
            chi_frac = chi_sel / chi_cap[rows, first]
        else:
            chi_frac = (chi_sel * K_180_OVER_PI) / (
                self._chi_max_rad * K_180_OVER_PI
            )
        if self.group == "432":
            # Reference formula verbatim (raw |eta|, degrees) — bit-exact
            # cubic parity including its out-of-sector fallback quirk.
            eta_frac = np.abs(eta[rows, first] * K_180_OVER_PI) / 45.0
        else:
            eta_frac = (eta_w[rows, first] - self._eta_min_rad) / (
                self._eta_max_rad - self._eta_min_rad
            )

        r = 1.0 - chi_frac
        b = eta_frac * chi_frac
        g = (1.0 - eta_frac) * chi_frac

        rgb = np.sqrt(np.stack([r, g, b], axis=-1))  # gamma correction
        rgb = rgb / rgb.max(axis=-1, keepdims=True)
        return np.round(255 * rgb).astype(np.int64)
