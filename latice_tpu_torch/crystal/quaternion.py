"""Quaternion / rotation algebra for crystallographic orientations, in torch.

Conventions are those of ``latice_tpu.crystal.quaternion``:

* quaternions are **scalar-first** ``(w, x, y, z)`` in tensors of shape
  ``(..., 4)``;
* ``quat_mul(q1, q2)`` is the Hamilton product, the rotation ``R1 @ R2``
  (apply ``R2`` first), like scipy's ``R1 * R2``;
* Euler angles are **extrinsic "zxz"** in degrees, like scipy's
  ``Rotation.from_euler("zxz", ..., degrees=True)``.

Every function broadcasts over leading dimensions and has no data-dependent
Python control flow, so a batch stays on its device end to end.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "quat_normalize",
    "quat_mul",
    "quat_inv",
    "quat_angle",
    "quat_canonical",
    "from_axis_angle",
    "from_euler_zxz_deg",
    "to_euler_zxz_deg",
    "quat_to_matrix",
    "matrix_to_euler_zxz_deg",
    "misorientation_angle",
    "misorientation_deg",
    "quat_mean",
    "quat_from_scipy",
    "quat_to_scipy",
]

_RAD = math.pi / 180.0
_DEG = 180.0 / math.pi


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions to unit length along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 ⊗ q2`` (scipy's ``R1 * R2``; applies R2 first)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (its conjugate)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians, in ``[0, pi]`` (scipy ``magnitude()``)."""
    vec_norm = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    return 2.0 * torch.atan2(vec_norm, q[..., 0].abs())


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """The representative with non-negative scalar part (q ≅ -q)."""
    return torch.where(q[..., :1] < 0, -q, q)


def from_axis_angle(axis: torch.Tensor, angle_rad: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation of ``angle_rad`` about unit vector ``axis``."""
    half = angle_rad[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def _axis_quat(angle_rad: torch.Tensor, axis_index: int) -> torch.Tensor:
    """Quaternion for a rotation about a coordinate axis (0=x, 1=y, 2=z)."""
    half = angle_rad / 2.0
    zeros = torch.zeros_like(half)
    parts = [torch.cos(half), zeros, zeros, zeros]
    parts[1 + axis_index] = torch.sin(half)
    return torch.stack(parts, dim=-1)


def from_euler_zxz_deg(angles_deg: torch.Tensor) -> torch.Tensor:
    """Quaternion from extrinsic-zxz Euler angles in degrees ``(..., 3)``.

    Extrinsic rotations apply in the order given about fixed axes, so
    ``R = Rz(a3) @ Rx(a2) @ Rz(a1)``.
    """
    a = angles_deg * _RAD
    q1 = _axis_quat(a[..., 0], 2)
    q2 = _axis_quat(a[..., 1], 0)
    q3 = _axis_quat(a[..., 2], 2)
    return quat_mul(q3, quat_mul(q2, q1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` from unit quaternions."""
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_zxz_deg(mat: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Extrinsic-zxz Euler angles (degrees) from rotation matrices.

    Extrinsic zxz ``(a1, a2, a3)`` equals intrinsic ZXZ ``(a3, a2, a1)``; the
    intrinsic angles come from ``R = Rz(p1) @ Rx(P) @ Rz(p2)`` and are
    swapped. Gimbal-locked inputs (``sin(P) ≈ 0``) put the whole z-rotation
    into the *first* extrinsic angle and zero the last, as scipy does.
    """
    r02, r12, r22 = mat[..., 0, 2], mat[..., 1, 2], mat[..., 2, 2]
    r20, r21 = mat[..., 2, 0], mat[..., 2, 1]
    r00, r10 = mat[..., 0, 0], mat[..., 1, 0]

    # atan2(sin, cos), not arccos(r22): near the poles cos(P) rounds to ±1
    # in f32 for tilts under ~0.04 deg, which would misroute them into the
    # lock branch; |sin(P)| = sqrt(r20^2 + r21^2) stays accurate there.
    sin_phi = torch.sqrt(r20 * r20 + r21 * r21)
    big_phi = torch.atan2(sin_phi, r22)
    degenerate = sin_phi < eps

    phi1 = torch.atan2(r02, -r12)
    phi2 = torch.atan2(r20, r21)

    # Gimbal lock: Rz(p1+p2) at Phi=0 (r22>0) or Rz(p1-p2)·Rx(pi) at Phi=pi;
    # r00=cos(f), r10=sin(f) for the folded angle f. The fold goes into the
    # extrinsic first slot: a1=f at Phi=0, a1=-f at Phi=pi.
    phi1_lock = torch.zeros_like(r00)
    phi2_lock = torch.atan2(torch.where(r22 > 0, r10, -r10), r00)

    phi1 = torch.where(degenerate, phi1_lock, phi1)
    phi2 = torch.where(degenerate, phi2_lock, phi2)
    return torch.stack([phi2, big_phi, phi1], dim=-1) * _DEG


def to_euler_zxz_deg(q: torch.Tensor) -> torch.Tensor:
    """Extrinsic-zxz Euler angles in degrees from quaternions ``(..., 4)``."""
    return matrix_to_euler_zxz_deg(quat_to_matrix(quat_normalize(q)))


def misorientation_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Misorientation angle in radians, ``(R1.inv() * R2).magnitude()``."""
    return quat_angle(quat_mul(quat_inv(q1), q2))


def misorientation_deg(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Misorientation angle in degrees (the FAISS backend's unit)."""
    return misorientation_angle(q1, q2) * _DEG


def quat_mean(
    quats: torch.Tensor,
    weights: torch.Tensor | None = None,
    method: str = "power",
    iterations: int = 30,
) -> torch.Tensor:
    """Weighted chordal-L2 mean rotation, as ``scipy.Rotation.mean()``.

    The mean is the leading eigenvector of ``M = Σ_i w_i q_i q_iᵀ`` over the
    second-to-last axis of ``quats`` ``(..., N, 4)``. ``method="power"``
    (the default) finds it by power iteration started from the
    sign-aligned weighted sum; all-zero weights start from the identity and
    give an arbitrary but finite result. ``"eigh"`` takes the last
    eigenvector of ``torch.linalg.eigh``.
    """
    q = quats if weights is None else quats * weights[..., None]
    m = torch.einsum("...ni,...nj->...ij", q, quats)
    if method == "eigh":
        # eigh returns ascending eigenvalues; the mean is the last eigenvector.
        _, vecs = torch.linalg.eigh(m)
        return quat_canonical(quat_normalize(vecs[..., :, -1]))

    v0 = quat_canonical(quats)
    if weights is not None:
        v0 = v0 * weights[..., None]
    v0 = v0.sum(dim=-2)
    degenerate = torch.linalg.vector_norm(v0, dim=-1, keepdim=True) < 1e-6
    identity = torch.zeros_like(v0)
    identity[..., 0] = 1.0
    v = quat_normalize(torch.where(degenerate, identity, v0))
    for _ in range(iterations):
        v = quat_normalize(torch.einsum("...ij,...j->...i", m, v))
    return quat_canonical(v)


def quat_from_scipy(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Scalar-last (scipy) quaternions to scalar-first."""
    return torch.cat([q_xyzw[..., 3:4], q_xyzw[..., 0:3]], dim=-1)


def quat_to_scipy(q_wxyz: torch.Tensor) -> torch.Tensor:
    """Scalar-first quaternions to scalar-last (scipy)."""
    return torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], dim=-1)
