"""Orientation-space sampling: dictionary grids over the fundamental zone.

The port's own copy of ``latice_tpu.crystal.sampling``, over the port's
`crystal.symmetry.ROTATION_GROUPS`; host numpy, so the grids and the
anglefiles are byte-identical to the JAX package's. A dictionary run needs
orientations that cover a point group's fundamental zone near-uniformly at
a chosen angular resolution:

* `sample_fundamental_zone(group, resolution_deg)`: a Halton sequence
  through Shoemake's map (quasi-uniform under the Haar measure,
  deterministic), each sample reduced to its nearest-to-identity
  crystal-symmetry image. The count is sized from the SO(3) ball volume
  ``(θ − sin θ)/π`` so the mean nearest-neighbour misorientation is
  ``resolution_deg``.
* `euler_grid(step_deg)`: the regular zxz grid of reference-style
  anglefiles.
"""

from __future__ import annotations

import math

import numpy as np

from latice_tpu_torch.crystal.symmetry import ROTATION_GROUPS

__all__ = [
    "euler_grid",
    "halton_sequence",
    "reduce_to_fundamental_zone",
    "sample_fundamental_zone",
    "sample_so3_halton",
    "so3_ball_fraction",
    "write_anglefile",
]


def halton_sequence(n: int, dims: int = 3, skip: int = 20) -> np.ndarray:
    """First ``n`` points of the Halton low-discrepancy sequence in [0,1)^dims.

    Small primes as bases; the first ``skip`` points are dropped (the usual
    correlated-prefix fix). Deterministic by construction.
    """
    primes = [2, 3, 5, 7, 11, 13][:dims]
    out = np.empty((n, dims), np.float64)
    for d, base in enumerate(primes):
        idx = np.arange(skip + 1, skip + n + 1, dtype=np.int64)
        x = np.zeros(n, np.float64)
        denom = 1.0
        i = idx.copy()
        while i.any():
            denom *= base
            x += (i % base) / denom
            i //= base
        out[:, d] = x
    return out


def sample_so3_halton(n: int) -> np.ndarray:
    """``(n, 4)`` scalar-first unit quaternions, quasi-uniform under the Haar
    measure — Shoemake's subgroup-algorithm map over a Halton sequence."""
    u = halton_sequence(n, 3)
    u1, u2, u3 = u[:, 0], u[:, 1], u[:, 2]
    a, b = np.sqrt(1.0 - u1), np.sqrt(u1)
    t2, t3 = 2 * np.pi * u2, 2 * np.pi * u3
    # (w, x, y, z): Shoemake's (sin/cos) arrangement, scalar moved first.
    return np.stack(
        [b * np.cos(t3), a * np.sin(t2), a * np.cos(t2), b * np.sin(t3)],
        axis=1,
    )


def reduce_to_fundamental_zone(quats: np.ndarray, group: str) -> np.ndarray:
    """Map each orientation to its fundamental-zone representative.

    The representative is the crystal-symmetry image ``q * s`` (s over the
    group's proper rotations, composed on the CRYSTAL side — the action
    under which this repo's active crystal→detector orientations are
    physically equivalent) with the largest ``|w|`` — the disorientation-
    from-identity criterion — canonicalized to ``w >= 0``. Orientations
    equal up to crystal symmetry map to the same row, and the returned
    representative IS the input orientation (zero misorientation), not a
    different one. Note the scalar part of a quaternion product is
    order-symmetric (``w(s⊗q) = w(q⊗s)``), so zone membership agrees with
    the sample-side reduction; only the representative differs.
    """
    try:
        sym = np.asarray(ROTATION_GROUPS[group], np.float64)
    except KeyError:
        raise ValueError(
            f"unknown point group {group!r}; choose from {sorted(ROTATION_GROUPS)}"
        ) from None
    q = np.asarray(quats, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    # Batched quaternion product q ⊗ s for all (S, N) pairs.
    sw, sx, sy, sz = sym[:, None].transpose(2, 0, 1)
    qw, qx, qy, qz = q[None].transpose(2, 0, 1)
    prod = np.stack(
        [
            qw * sw - qx * sx - qy * sy - qz * sz,
            qw * sx + qx * sw + qy * sz - qz * sy,
            qw * sy - qx * sz + qy * sw + qz * sx,
            qw * sz + qx * sy - qy * sx + qz * sw,
        ],
        axis=-1,
    )  # (S, N, 4)
    best = np.argmax(np.abs(prod[..., 0]), axis=0)  # (N,)
    rep = prod[best, np.arange(len(q))]
    return np.where(rep[:, :1] < 0, -rep, rep)


def so3_ball_fraction(theta_rad: float) -> float:
    """Exact Haar fraction of SO(3) within misorientation ``theta`` of a
    point: ``(theta - sin theta) / pi``."""
    return (theta_rad - math.sin(theta_rad)) / math.pi


def sample_fundamental_zone(
    group: str = "432",
    resolution_deg: float = 2.0,
    max_samples: int = 2_000_000,
) -> np.ndarray:
    """Quasi-uniform orientation samples covering one fundamental zone.

    Args:
        group: proper point group (a `ROTATION_GROUPS` key).
        resolution_deg: target *mean* nearest-neighbour misorientation
            between samples. Max gap (covering radius) is ~2x this for the
            low-discrepancy set (tests pin it).
        max_samples: safety cap on the returned count.

    Returns:
        ``(M, 4)`` scalar-first unit quaternions inside the fundamental
        zone, ``M ≈ 1 / (|G| · frac(resolution))``.
    """
    if resolution_deg <= 0:
        raise ValueError("resolution_deg must be positive")
    order = len(ROTATION_GROUPS[group]) if group in ROTATION_GROUPS else None
    if order is None:
        raise ValueError(
            f"unknown point group {group!r}; choose from {sorted(ROTATION_GROUPS)}"
        )
    frac = so3_ball_fraction(math.radians(resolution_deg))
    m = int(round(1.0 / (order * frac)))
    if m > max_samples:
        raise ValueError(
            f"{group} at {resolution_deg}° needs ~{m:,} samples "
            f"(> max_samples={max_samples:,}); coarsen the resolution or "
            "raise the cap"
        )
    m = max(m, 1)
    # Sample the whole of SO(3) and reduce: every draw lands in the zone,
    # so n draws give n zone samples at |G|x the zone density.
    return reduce_to_fundamental_zone(sample_so3_halton(m), group)


def euler_grid(
    step_deg: float = 1.0,
    phi1_range: tuple[float, float] = (0.0, 360.0),
    Phi_range: tuple[float, float] = (0.0, 90.0),
    phi2_range: tuple[float, float] = (0.0, 90.0),
) -> np.ndarray:
    """Regular zxz Euler grid in degrees (reference anglefile style).

    Endpoints are half-open (``[start, stop)``), matching the 625-row 1°
    sample grid the reference ships (data/anglefile_sample.txt). Note a
    regular Euler grid is NOT volume-uniform (it oversamples Phi≈0); prefer
    `sample_fundamental_zone` for new dictionaries.
    """
    if step_deg <= 0:
        raise ValueError("step_deg must be positive")
    ax = [
        np.arange(lo, hi - 1e-9, step_deg, dtype=np.float64)
        for lo, hi in (phi1_range, Phi_range, phi2_range)
    ]
    g = np.meshgrid(*ax, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=1)


def write_anglefile(path: str, eulers_deg: np.ndarray) -> None:
    """Write zxz Euler degrees in the reference anglefile format: an ``eu``
    convention line, a count line, then one ``z1 x z2`` triple per row
    (reference data/anglefile_sample.txt, parsed at data_module.py:87-116)."""
    e = np.asarray(eulers_deg, np.float64)
    if e.ndim != 2 or e.shape[1] != 3:
        raise ValueError(f"expected (N, 3) Euler degrees, got {e.shape}")
    with open(path, "w") as f:
        f.write("eu\n")
        f.write(f"{len(e)}\n")
        for row in e:
            f.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}\n")
