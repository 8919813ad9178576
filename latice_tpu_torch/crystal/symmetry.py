"""Crystal symmetry operators and the symmetry snap used by consensus.

The tables are the port's own copy of ``latice_tpu.crystal.symmetry``'s:
the proper-rotation point groups of the 7 crystal systems as scalar-first
quaternions, built on the host in float64.
"""

from __future__ import annotations

from math import pi, sqrt

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import misorientation_angle, quat_mul

__all__ = [
    "CUBIC_SYMMETRY",
    "QUAT_SYM_WXYZ",
    "ROTATION_GROUPS",
    "apply_symmetry_to_axes",
    "cubic_symmetry_quats",
    "symmetry_quats",
    "stack_symmetry_tables",
    "nearest_symmetry_equivalent",
    "symmetry_reduced_misorientation",
    "PI_OVER_180",
    "K_180_OVER_PI",
    "SQRT2_INV",
    "SQRT3_INV",
    "USE_INVERSION",
]

PI_OVER_180 = pi / 180
K_180_OVER_PI = 180 / pi
SQRT2_INV = 1 / sqrt(2)
SQRT3_INV = 1 / sqrt(3)
USE_INVERSION = True

# The 24 rotations of the cubic system in the reference's on-disk layout,
# scipy scalar-LAST (x, y, z, w).
CUBIC_SYMMETRY: list[list[float]] = [
    [1, 0, 0, 0],
    [0, 1, 0, 0],
    [0, 0, 1, 0],
    [0, 0, 0, 1],
    [0.5, 0.5, 0.5, 0.5],
    [0.5, -0.5, -0.5, -0.5],
    [0.5, 0.5, -0.5, 0.5],
    [0.5, -0.5, 0.5, -0.5],
    [0.5, -0.5, 0.5, 0.5],
    [0.5, 0.5, -0.5, -0.5],
    [0.5, -0.5, -0.5, 0.5],
    [0.5, 0.5, 0.5, -0.5],
    [SQRT2_INV, SQRT2_INV, 0, 0],
    [SQRT2_INV, 0, SQRT2_INV, 0],
    [SQRT2_INV, 0, 0, SQRT2_INV],
    [SQRT2_INV, -SQRT2_INV, 0, 0],
    [SQRT2_INV, 0, -SQRT2_INV, 0],
    [SQRT2_INV, 0, 0, -SQRT2_INV],
    [0, SQRT2_INV, SQRT2_INV, 0],
    [0, -SQRT2_INV, SQRT2_INV, 0],
    [0, 0, SQRT2_INV, SQRT2_INV],
    [0, 0, -SQRT2_INV, SQRT2_INV],
    [0, SQRT2_INV, 0, SQRT2_INV],
    [0, -SQRT2_INV, 0, SQRT2_INV],
]

_SYM_XYZW = np.asarray(CUBIC_SYMMETRY, dtype=np.float64)
QUAT_SYM_WXYZ: np.ndarray = np.concatenate([_SYM_XYZW[:, 3:4], _SYM_XYZW[:, 0:3]], axis=1)


def cubic_symmetry_quats(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The 24 cubic symmetry operators as scalar-first unit quaternions."""
    return torch.as_tensor(QUAT_SYM_WXYZ, dtype=dtype, device=device)


def _aa(axis, angle: float) -> np.ndarray:
    """Scalar-first quaternion about ``axis`` by ``angle`` radians."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2.0)], np.sin(angle / 2.0) * axis])


def _cyclic(n: int) -> np.ndarray:
    """Cn: n rotations about z."""
    return np.stack([_aa([0, 0, 1], 2 * pi * k / n) for k in range(n)])


def _dihedral(n: int) -> np.ndarray:
    """Dn: Cn about z plus n two-fold axes in the basal plane."""
    twofolds = [_aa([np.cos(pi * k / n), np.sin(pi * k / n), 0], pi) for k in range(n)]
    return np.concatenate([_cyclic(n), np.stack(twofolds)])


def _tetrahedral() -> np.ndarray:
    """T (point group 23): identity, three face two-folds, and the eight
    +120° rotations about the (±1, ±1, ±1) axes."""
    diag = [
        _aa([sx, sy, sz], 2 * pi / 3)
        for sx in (1, -1)
        for sy in (1, -1)
        for sz in (1, -1)
    ]
    return np.concatenate(
        [
            _cyclic(1),
            np.stack([_aa(a, pi) for a in ([1, 0, 0], [0, 1, 0], [0, 0, 1])]),
            np.stack(diag),
        ]
    )


# Proper-rotation point groups (Hermann-Mauguin names).
ROTATION_GROUPS: dict[str, np.ndarray] = {
    "1": _cyclic(1),
    "2": _cyclic(2),
    "222": _dihedral(2),
    "3": _cyclic(3),
    "32": _dihedral(3),
    "4": _cyclic(4),
    "422": _dihedral(4),
    "6": _cyclic(6),
    "622": _dihedral(6),
    "23": _tetrahedral(),
    "432": QUAT_SYM_WXYZ,
}


def symmetry_quats(
    group: str = "432", dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Rotation operators of a proper point group, scalar-first ``(S, 4)``."""
    try:
        table = ROTATION_GROUPS[group]
    except KeyError:
        raise ValueError(
            f"unknown point group {group!r}; choose from {sorted(ROTATION_GROUPS)}"
        ) from None
    return torch.as_tensor(table, dtype=dtype, device=device)


def stack_symmetry_tables(
    groups, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Stack per-phase symmetry tables into one ``(P, S_max, 4)`` tensor.

    Shorter groups are padded by repeating their first row: a duplicate
    operator changes no min/argmin over the images.
    """
    tables = [np.asarray(ROTATION_GROUPS[g] if isinstance(g, str) else g) for g in groups]
    s_max = max(len(t) for t in tables)
    out = np.stack(
        [np.concatenate([t, np.tile(t[:1], (s_max - len(t), 1))]) for t in tables]
    )
    return torch.as_tensor(out, dtype=dtype, device=device)


def _symmetry_images(q: torch.Tensor, sym: torch.Tensor, compose: str) -> torch.Tensor:
    """Every symmetry image of ``q``, ``(..., S, 4)``, on the chosen side."""
    if compose == "sample":
        return quat_mul(sym, q[..., None, :])
    if compose == "crystal":
        return quat_mul(q[..., None, :], sym)
    raise ValueError(f"compose must be 'sample' or 'crystal', got {compose!r}")


def symmetry_reduced_misorientation(
    q1: torch.Tensor,
    q2: torch.Tensor,
    sym: torch.Tensor | None = None,
    compose: str = "crystal",
) -> torch.Tensor:
    """Least misorientation angle (radians) of ``q1`` to any symmetry image
    of ``q2``: the disorientation angle.

    ``compose="crystal"`` (the default) takes the images ``q2 ⊗ sym_k``, so
    two fundamental-zone representatives of one orientation measure ≈ 0;
    ``"sample"`` takes ``sym_k ⊗ q2``. ``sym`` defaults to the cubic group.
    """
    if sym is None:
        sym = symmetry_quats("432", dtype=q2.dtype, device=q2.device)
    images = _symmetry_images(q2, sym, compose)
    return misorientation_angle(q1[..., None, :], images).amin(dim=-1)


def nearest_symmetry_equivalent(
    ref: torch.Tensor,
    cand: torch.Tensor,
    sym: torch.Tensor | None = None,
    compose: str = "sample",
) -> torch.Tensor:
    """Symmetry-equivalent of ``cand`` closest to ``ref``.

    ``compose="sample"`` takes the images ``sym_k ⊗ cand`` (the reference's
    FAISS semantics and the consensus snap); ``"crystal"`` takes
    ``cand ⊗ sym_k``. ``sym`` is ``(S, 4)`` or any table broadcasting
    against ``cand[..., None, :]``, e.g. ``(B, 1, S, 4)`` per query; it
    defaults to the cubic group. The first closest image wins a tie.
    """
    if sym is None:
        sym = symmetry_quats("432", dtype=cand.dtype, device=cand.device)
    images = _symmetry_images(cand, sym, compose)
    delta = misorientation_angle(ref[..., None, :], images)
    images = images.expand(*delta.shape, 4)
    idx = torch.argmin(delta, dim=-1, keepdim=True)
    return torch.gather(images, -2, idx[..., None].expand(*idx.shape, 4)).squeeze(-2)


def apply_symmetry_to_axes(axes: np.ndarray, group: str = "432") -> np.ndarray:
    """Expand direction vectors by a point group's operators (host numpy).

    ``axes`` is ``(3,)`` or ``(N, 3)``; the result is ``(S, 3)`` or
    ``(N, S, 3)`` for a group of order S. The cubic group keeps the
    reference's own table and order, which the IPF color key's first-match
    rule depends on.
    """
    from scipy.spatial.transform import Rotation as R

    if group == "432":
        quats_xyzw = np.asarray(CUBIC_SYMMETRY)
    else:
        wxyz = np.asarray(ROTATION_GROUPS[group])
        quats_xyzw = np.concatenate([wxyz[:, 1:4], wxyz[:, 0:1]], axis=1)
    mats = R.from_quat(quats_xyzw).as_matrix()
    return np.einsum("sij,...j->...si", mats, np.asarray(axes, dtype=np.float64))
