"""Pole figures: stereographic texture plots of orientation sets (host numpy;
the port's own copy of ``latice_tpu/utils/polefigure.py``).

Texture analysis standard in every EBSD workflow (and absent from the
reference, which stops at latent scatter plots — utils.py:151-203): for each
orientation, the chosen crystal direction (pole) is expanded by the phase's
point-group symmetry, rotated into the sample frame, folded to the upper
hemisphere, and stereographically projected onto the unit disk.

Host-side numpy throughout — this is plotting-scale math (a few matrix
products per orientation), and keeping it off-device follows the repo rule
that host math is numpy.

Conventions: zxz extrinsic Euler degrees in, Bunge-style ``g`` mapping sample
-> crystal frames, so sample-frame pole directions are ``g^T (s @ pole)``.
"""

from __future__ import annotations

import numpy as np

from latice_tpu_torch.crystal.symmetry import ROTATION_GROUPS

__all__ = ["compute_pole_figure", "plot_odf_sections", "plot_pole_figure"]


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """Scalar-first quaternions ``(..., 4)`` -> rotation matrices ``(..., 3, 3)``.

    Same formula as crystal.quaternion.quat_to_matrix, in numpy for host use.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def _euler_zxz_to_matrix_np(euler_deg: np.ndarray) -> np.ndarray:
    """Extrinsic-zxz Euler degrees -> matrices, ``Rz(a3) Rx(a2) Rz(a1)``
    (crystal.quaternion.from_euler_zxz_deg semantics, scipy-parity)."""
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


def compute_pole_figure(
    euler_deg: np.ndarray,
    pole: tuple[float, float, float] = (1.0, 0.0, 0.0),
    group: str = "432",
) -> np.ndarray:
    """Stereographic coordinates of the symmetry-expanded pole directions.

    Args:
        euler_deg: ``(N, 3)`` zxz extrinsic Euler angles (degrees).
        pole: Crystal direction, e.g. ``(1, 0, 0)`` or ``(1, 1, 1)``; need not
            be normalized.
        group: Proper rotation point group (`crystal.ROTATION_GROUPS` key).

    Returns:
        ``(N * S, 2)`` float64 points inside the closed unit disk: every
        symmetry image of the pole, folded to the upper hemisphere
        (antipodes identified) and projected ``(x, y) / (1 + z)``.
    """
    euler = np.atleast_2d(np.asarray(euler_deg, dtype=np.float64))
    if euler.ndim != 2 or euler.shape[1] != 3:
        raise ValueError(f"expected (N, 3) Euler angles, got {euler.shape}")
    h = np.asarray(pole, dtype=np.float64)
    h = h / np.linalg.norm(h)
    try:
        sym = np.asarray(ROTATION_GROUPS[group], dtype=np.float64)
    except KeyError:
        raise ValueError(
            f"unknown point group {group!r}; choose from {sorted(ROTATION_GROUPS)}"
        ) from None

    crystal_dirs = _quat_to_matrix_np(sym) @ h  # (S, 3) symmetry images
    g = _euler_zxz_to_matrix_np(euler)  # (N, 3, 3), sample -> crystal
    # Sample-frame directions: g^T applied to every symmetry image.
    dirs = np.einsum("nji,sj->nsi", g, crystal_dirs).reshape(-1, 3)
    # Fold to the upper hemisphere (poles are axes: d and -d are the same).
    dirs = np.where(dirs[:, 2:3] < 0, -dirs, dirs)
    return dirs[:, :2] / (1.0 + dirs[:, 2:3])


def plot_pole_figure(
    euler_deg: np.ndarray,
    pole: tuple[float, float, float] = (1.0, 0.0, 0.0),
    group: str = "432",
    ax=None,
    **scatter_kw,
):
    """Scatter the pole figure on a unit-disk axis; returns the figure.

    Any matplotlib scatter keyword passes through (``s``, ``alpha``, ``c``...).
    """
    from latice_tpu_torch.utils._mpl import ensure_headless_backend

    ensure_headless_backend()
    import matplotlib.pyplot as plt

    pts = compute_pole_figure(euler_deg, pole, group)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5), dpi=120)
    else:
        fig = ax.figure
    kw = {"s": 4, "alpha": 0.6, **scatter_kw}
    ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, lw=1.0, color="k"))
    ax.scatter(pts[:, 0], pts[:, 1], **kw)
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    ax.set_aspect("equal")
    ax.axis("off")
    h = tuple(int(v) if float(v).is_integer() else v for v in pole)
    ax.set_title(f"{{{h[0]}{h[1]}{h[2]}}} pole figure ({group})")
    return fig


def plot_odf_sections(
    sections: np.ndarray,
    phi1_deg: np.ndarray,
    phi_deg: np.ndarray,
    phi2_deg,
    ax=None,
):
    """Render constant-φ2 ODF sections (crystal.odf.odf_sections output).

    One row of filled-contour panels sharing a color scale in multiples of
    uniform; returns the figure. ``ax`` may be a sequence of axes (one per
    section) for embedding.
    """
    from latice_tpu_torch.utils._mpl import ensure_headless_backend

    ensure_headless_backend()
    import matplotlib.pyplot as plt

    sections = np.asarray(sections)
    n = len(sections)
    if ax is None:
        fig, axes = plt.subplots(
            1, n, figsize=(3.4 * n + 1.2, 3.4), dpi=120, squeeze=False
        )
        axes = axes[0]
    else:
        axes = np.atleast_1d(ax)
        fig = axes[0].figure
    vmax = max(float(sections.max()), 1.0)
    im = None
    for i, (sec, p2) in enumerate(zip(sections, phi2_deg)):
        a = axes[i]
        im = a.imshow(
            sec,
            origin="upper",
            extent=(phi1_deg[0], phi1_deg[-1], phi_deg[-1], phi_deg[0]),
            vmin=0.0,
            vmax=vmax,
            cmap="viridis",
            aspect="equal",
        )
        a.set_title(f"φ2 = {p2:g}°")
        a.set_xlabel("φ1 (°)")
        if i == 0:
            a.set_ylabel("Φ (°)")
    fig.colorbar(im, ax=list(axes), label="f(g) (× uniform)", shrink=0.85)
    return fig
