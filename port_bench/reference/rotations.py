"""Rotations for the plain reference, in numpy float64.

Scalar-first unit quaternions. Euler angles are extrinsic zxz in degrees,
``R = Rz(a3) Rx(a2) Rz(a1)``, the convention of the reference's FAISS
backend (scipy's ``Rotation.from_euler("zxz", ..., degrees=True)``).
The point groups are generated here from their definitions, not read from
the program.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = [
    "angle",
    "from_euler_zxz_deg",
    "from_matrix",
    "inv",
    "mul",
    "point_group",
]


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product ``a ⊗ b``, broadcasting over leading axes."""
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def inv(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def angle(q: np.ndarray) -> np.ndarray:
    """Rotation angle in radians of (not necessarily unit) quaternions."""
    return 2.0 * np.arctan2(np.linalg.norm(q[..., 1:], axis=-1), np.abs(q[..., 0]))


def misorientation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle in radians of ``a⁻¹ ⊗ b``, no symmetry."""
    return angle(mul(inv(a), b))


def _axis(angle_rad: np.ndarray, axis: int) -> np.ndarray:
    half = 0.5 * np.asarray(angle_rad, np.float64)
    q = np.zeros(half.shape + (4,))
    q[..., 0] = np.cos(half)
    q[..., 1 + axis] = np.sin(half)
    return q


def from_euler_zxz_deg(euler: np.ndarray) -> np.ndarray:
    a = np.deg2rad(np.asarray(euler, np.float64))
    return mul(_axis(a[..., 2], 2), mul(_axis(a[..., 1], 0), _axis(a[..., 0], 2)))


def from_matrix(m: np.ndarray) -> np.ndarray:
    """Unit quaternion of one proper rotation matrix (w >= 0)."""
    w = 0.5 * np.sqrt(max(0.0, 1.0 + np.trace(m)))
    if w > 1e-6:
        q = np.array([w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
                      (m[1, 0] - m[0, 1]) / (4 * w)])
    else:  # a half turn: the axis from the diagonal
        xyz = np.sqrt(np.maximum(0.0, (np.diag(m) + 1.0) / 2.0))
        i = int(np.argmax(xyz))
        xyz[i] = np.sqrt(max(0.0, (m[i, i] + 1.0) / 2.0))
        for j in range(3):
            if j != i:
                xyz[j] = (m[i, j] + m[j, i]) / (4.0 * xyz[i])
        q = np.array([0.0, *xyz])
    return q / np.linalg.norm(q)


def point_group(name: str) -> np.ndarray:
    """The proper rotations of a point group, ``(S, 4)``: "432" (the 24
    signed permutation matrices of determinant +1) or "622" (six turns
    about z by 60° and six half turns about axes in the basal plane)."""
    if name == "432":
        mats = []
        for perm in itertools.permutations(range(3)):
            for signs in itertools.product((1.0, -1.0), repeat=3):
                m = np.zeros((3, 3))
                for r, (c, s) in enumerate(zip(perm, signs)):
                    m[r, c] = s
                if np.linalg.det(m) > 0:
                    mats.append(m)
        return np.stack([from_matrix(m) for m in mats])
    if name == "622":
        k = np.arange(6)
        turns = _axis(np.deg2rad(60.0 * k), 2)
        t = np.deg2rad(30.0 * k)
        halves = np.stack([np.zeros(6), np.cos(t), np.sin(t), np.zeros(6)], axis=-1)
        return np.concatenate([turns, halves])
    raise ValueError(f"unknown point group {name!r}")
