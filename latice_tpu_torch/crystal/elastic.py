"""Elastic anisotropy maps: directional stiffness from orientation data
(host numpy; the port's own copy of ``latice_tpu/crystal/elastic.py``).

Single crystals are elastically anisotropic (Cu's Young's modulus spans
66–191 GPa between ⟨100⟩ and ⟨111⟩); an orientation map therefore implies
a stiffness map under a given load direction — MTEX's
``YoungsModulus``/tensor plotting capability, absent from the reference,
and the bridge from indexing output to micromechanics.

Math. With compliance ``s_ijkl`` (crystal frame, from the Voigt 6×6 by the
standard factor rules) and the load direction rotated into the crystal
frame per pixel (``d_c = g d_s``; ``g`` maps sample → crystal, the repo
convention), the uniaxial Young's modulus is

    1/E(d) = s_ijkl d_i d_j d_k d_l ,

one 81-term contraction per pixel, batched over the map. The module is
symmetry-agnostic: any Voigt stiffness works; `cubic_stiffness` builds the
(C11, C12, C44) case and `CUBIC_STIFFNESS` ships measured constants for
common phases. Polycrystal Voigt/Reuss/Hill bounds come from the usual
matrix invariants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "CUBIC_STIFFNESS",
    "PolycrystalModuli",
    "cubic_stiffness",
    "directional_youngs_modulus",
    "polycrystal_moduli",
]

#: Measured single-crystal stiffness constants (GPa): C11, C12, C44.
CUBIC_STIFFNESS: dict[str, tuple[float, float, float]] = {
    "al": (106.8, 60.4, 28.3),
    "cu": (168.4, 121.4, 75.4),
    "ni": (246.5, 147.3, 124.7),
    "fe-alpha": (231.4, 134.7, 116.4),
    "fe-gamma": (197.5, 124.5, 122.0),
    "w": (522.4, 204.4, 160.8),  # nearly isotropic (Zener A ≈ 1.01)
}

_VOIGT_PAIRS = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def cubic_stiffness(c11: float, c12: float, c44: float) -> np.ndarray:
    """The (6, 6) Voigt stiffness matrix of a cubic crystal (GPa in → out)."""
    c = np.zeros((6, 6))
    c[:3, :3] = c12
    np.fill_diagonal(c[:3, :3], c11)
    c[3:, 3:] = np.diag([c44, c44, c44])
    return c


def _resolve_stiffness(stiffness) -> np.ndarray:
    if isinstance(stiffness, str):
        try:
            stiffness = CUBIC_STIFFNESS[stiffness.lower()]
        except KeyError:
            raise ValueError(
                f"unknown material {stiffness!r}; known: "
                f"{', '.join(CUBIC_STIFFNESS)} (or pass (C11, C12, C44) / "
                "a (6, 6) Voigt matrix)"
            ) from None
    arr = np.asarray(stiffness, np.float64)
    if arr.shape == (3,):
        arr = cubic_stiffness(*arr)
    if arr.shape != (6, 6):
        raise ValueError(
            f"stiffness must be (C11, C12, C44) or a (6, 6) Voigt matrix, "
            f"got shape {arr.shape}"
        )
    if not np.allclose(arr, arr.T, atol=1e-9):
        raise ValueError("Voigt stiffness matrix must be symmetric")
    return arr


def _compliance_tensor(c_voigt: np.ndarray) -> np.ndarray:
    """(3, 3, 3, 3) compliance from a (6, 6) Voigt stiffness.

    Voigt compliance rules: s_ijkl = S_mn / (f_m f_n) with f = 1 for normal
    (m ≤ 3) and 2 for shear (m ≥ 4) components.
    """
    s_voigt = np.linalg.inv(c_voigt)
    s = np.zeros((3, 3, 3, 3))
    for m, (i, j) in enumerate(_VOIGT_PAIRS):
        for n, (k, l) in enumerate(_VOIGT_PAIRS):
            val = s_voigt[m, n] / ((1.0 if m < 3 else 2.0) * (1.0 if n < 3 else 2.0))
            for a, b in ((i, j), (j, i)):
                for c, d in ((k, l), (l, k)):
                    s[a, b, c, d] = val
    return s


def _euler_zxz_to_matrix_np(euler_deg: np.ndarray) -> np.ndarray:
    """Extrinsic-zxz Euler degrees -> matrices, ``Rz(a3) Rx(a2) Rz(a1)``
    (`crystal.from_euler_zxz_deg` semantics, scipy-parity)."""
    a = np.deg2rad(np.asarray(euler_deg, dtype=np.float64))

    def rz(t):
        c, s = np.cos(t), np.sin(t)
        m = np.zeros(t.shape + (3, 3))
        m[..., 0, 0], m[..., 0, 1] = c, -s
        m[..., 1, 0], m[..., 1, 1] = s, c
        m[..., 2, 2] = 1.0
        return m

    def rx(t):
        c, s = np.cos(t), np.sin(t)
        m = np.zeros(t.shape + (3, 3))
        m[..., 0, 0] = 1.0
        m[..., 1, 1], m[..., 1, 2] = c, -s
        m[..., 2, 1], m[..., 2, 2] = s, c
        return m

    return rz(a[..., 2]) @ rx(a[..., 1]) @ rz(a[..., 0])


def directional_youngs_modulus(
    euler_deg: np.ndarray,
    load_direction=(0.0, 0.0, 1.0),
    stiffness="fe-alpha",
) -> np.ndarray:
    """Per-pixel uniaxial Young's modulus under a sample-frame load (GPa).

    Args:
        euler_deg: ``(..., 3)`` zxz Euler degrees (map grid or flat).
        load_direction: sample-frame load axis (normalized internally).
        stiffness: `CUBIC_STIFFNESS` name, ``(C11, C12, C44)`` in GPa, or a
            full ``(6, 6)`` Voigt matrix (any crystal symmetry).

    Returns:
        Young's modulus array with ``euler_deg.shape[:-1]``, GPa.
    """
    euler = np.asarray(euler_deg, np.float32)
    if euler.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) Euler angles, got {euler.shape}")
    d = np.asarray(load_direction, np.float64)
    norm = np.linalg.norm(d)
    if d.shape != (3,) or norm == 0:
        raise ValueError(f"load_direction must be a nonzero 3-vector, got {d}")
    d = d / norm
    s = _compliance_tensor(_resolve_stiffness(stiffness))
    # Host numpy end to end: an 81-term contraction per pixel.
    g = _euler_zxz_to_matrix_np(
        euler.reshape(-1, 3).astype(np.float64)
    )  # (N, 3, 3) sample->crystal
    dc = g @ d  # (N, 3) load in crystal coords
    inv_e = np.einsum("ijkl,ni,nj,nk,nl->n", s, dc, dc, dc, dc)
    return (1.0 / inv_e).reshape(euler.shape[:-1])


class PolycrystalModuli(NamedTuple):
    """Voigt/Reuss/Hill polycrystal averages (GPa) of a stiffness tensor."""

    bulk_voigt: float
    bulk_reuss: float
    shear_voigt: float
    shear_reuss: float
    #: Hill-average Young's modulus and Poisson ratio.
    youngs_hill: float
    poisson_hill: float


def polycrystal_moduli(stiffness="fe-alpha") -> PolycrystalModuli:
    """Voigt/Reuss/Hill isotropic averages of a single-crystal stiffness.

    The texture-free reference values to compare a map's directional
    modulus against (Voigt = uniform strain upper bound, Reuss = uniform
    stress lower bound, Hill their mean).
    """
    c = _resolve_stiffness(stiffness)
    s = np.linalg.inv(c)
    k_v = (c[0, 0] + c[1, 1] + c[2, 2] + 2 * (c[0, 1] + c[0, 2] + c[1, 2])) / 9.0
    g_v = (
        c[0, 0] + c[1, 1] + c[2, 2]
        - (c[0, 1] + c[0, 2] + c[1, 2])
        + 3 * (c[3, 3] + c[4, 4] + c[5, 5])
    ) / 15.0
    k_r = 1.0 / (s[0, 0] + s[1, 1] + s[2, 2] + 2 * (s[0, 1] + s[0, 2] + s[1, 2]))
    g_r = 15.0 / (
        4 * (s[0, 0] + s[1, 1] + s[2, 2])
        - 4 * (s[0, 1] + s[0, 2] + s[1, 2])
        + 3 * (s[3, 3] + s[4, 4] + s[5, 5])
    )
    k_h, g_h = 0.5 * (k_v + k_r), 0.5 * (g_v + g_r)
    e_h = 9.0 * k_h * g_h / (3.0 * k_h + g_h)
    nu_h = (3.0 * k_h - 2.0 * g_h) / (2.0 * (3.0 * k_h + g_h))
    return PolycrystalModuli(
        bulk_voigt=float(k_v),
        bulk_reuss=float(k_r),
        shear_voigt=float(g_v),
        shear_reuss=float(g_r),
        youngs_hill=float(e_h),
        poisson_hill=float(nu_h),
    )
