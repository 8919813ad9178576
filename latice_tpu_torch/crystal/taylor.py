"""Taylor factor maps: full-constraints polycrystal plasticity per pixel
(host numpy; the port's own copy of ``latice_tpu/crystal/taylor.py``).

The Taylor factor M relates the macroscopic flow stress of a grain to the
critical resolved shear stress under the full-constraints assumption (every
grain accommodates the imposed strain): σ_flow = M·τ_c, with M depending on
the grain's orientation relative to the strain — the standard
strength-anisotropy map (MTEX's ``calcTaylor``), complementing the
Schmid-factor (single-slip) view in `crystal.schmid`.

Method. Bishop & Hill (1951): under full constraints the plastic work is
maximized over the vertices of the single-crystal yield polytope
``{σ deviatoric : |σ : P_s| ≤ τ_c for all slip systems}``,
``P_s = sym(b ⊗ n)``, and

    M(g) = max_vertices (σ* : ε_c) / (τ_c · ε_vM) ,   ε_c = g ε_s gᵀ.

Rather than hard-coding the published 28-vertex fcc table, the polytope
vertices are ENUMERATED from the slip family itself (all 5-subsets of the
systems' Schmid tensors in the 5-D deviatoric basis, all activation signs,
feasibility-filtered, deduplicated) — generic over `crystal.schmid`'s
families and self-validating: the fcc {111}⟨110⟩ enumeration reproduces
exactly the 56 (= ±28) Bishop–Hill stress states, and the classic anchors
M⟨100⟩ = 2.449, M⟨111⟩ = 3.674, random-texture mean 3.067 are pinned in
tests. bcc {110}⟨111⟩ yields the same polytope (sym(b⊗n) is invariant
under b ↔ n — the classical fcc/bcc duality); bcc112 gets its own.

Everything is host numpy: per-pixel work is one (V, 5)×(5, N) matmul over
the enumerated vertices — microseconds per map, no device dispatch.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np

from latice_tpu_torch.crystal.schmid import SLIP_FAMILIES, slip_systems

__all__ = [
    "TaylorResult",
    "bishop_hill_vertices",
    "taylor_factors",
]

_SQ2, _SQ6 = np.sqrt(2.0), np.sqrt(6.0)


def _to_dev5(t: np.ndarray) -> np.ndarray:
    """Symmetric traceless (..., 3, 3) -> orthonormal 5-vector components."""
    return np.stack(
        [
            (t[..., 0, 0] - t[..., 1, 1]) / _SQ2,
            t[..., 2, 2] * np.sqrt(1.5),
            t[..., 1, 2] * _SQ2,
            t[..., 0, 2] * _SQ2,
            t[..., 0, 1] * _SQ2,
        ],
        axis=-1,
    )


def _from_dev5(v: np.ndarray) -> np.ndarray:
    """Inverse of `_to_dev5`."""
    t = np.zeros(v.shape[:-1] + (3, 3))
    t[..., 2, 2] = v[..., 1] / np.sqrt(1.5)
    t[..., 0, 0] = (v[..., 0] * _SQ2 - t[..., 2, 2]) / 2.0
    t[..., 1, 1] = -t[..., 0, 0] - t[..., 2, 2]
    t[..., 1, 2] = t[..., 2, 1] = v[..., 2] / _SQ2
    t[..., 0, 2] = t[..., 2, 0] = v[..., 3] / _SQ2
    t[..., 0, 1] = t[..., 1, 0] = v[..., 4] / _SQ2
    return t


@lru_cache(maxsize=None)
def _vertices_dev5(family: str) -> np.ndarray:
    """Yield-polytope vertices in the 5-D deviatoric basis, τ_c = 1."""
    from itertools import combinations

    normals, directions = slip_systems(family, dtype=np.float64)
    p = 0.5 * (
        directions[:, :, None] * normals[:, None, :]
        + normals[:, :, None] * directions[:, None, :]
    )  # (S, 3, 3) Schmid tensors
    p5 = _to_dev5(p)  # (S, 5); σ : P == ⟨σ5, p5⟩ under this basis
    s = len(p5)
    signs = np.asarray(
        [[1 if (m >> k) & 1 else -1 for k in range(5)] for m in range(32)],
        np.float64,
    )  # (32, 5)
    found: dict[tuple, np.ndarray] = {}
    for idx in combinations(range(s), 5):
        a = p5[list(idx)]  # (5, 5)
        if abs(np.linalg.det(a)) < 1e-9:
            continue
        sols = np.linalg.solve(a, signs.T).T  # (32, 5)
        feas = np.abs(sols @ p5.T).max(axis=1) <= 1.0 + 1e-9
        for v in sols[feas]:
            found.setdefault(tuple(np.round(v, 9)), v)
    if not found:
        raise ValueError(f"no yield vertices found for family {family!r}")
    return np.stack(list(found.values()))


def bishop_hill_vertices(family: str = "fcc") -> np.ndarray:
    """The single-crystal yield-polytope vertices ``(V, 3, 3)`` at τ_c = 1.

    fcc (and, by the b ↔ n duality, bcc {110}⟨111⟩): the 56 = ±28 classical
    Bishop–Hill stress states, recovered by enumeration rather than table.
    """
    if family not in SLIP_FAMILIES:
        raise ValueError(
            f"unknown slip family {family!r}; known: {SLIP_FAMILIES}"
        )
    return _from_dev5(_vertices_dev5(family))


class TaylorResult(NamedTuple):
    """Per-pixel Taylor analysis (host arrays, input leading shape)."""

    #: Full-constraints Taylor factor M (flow stress = M · τ_c).
    factor: np.ndarray
    #: Index of the work-maximizing yield vertex (into `bishop_hill_vertices`).
    vertex: np.ndarray


def taylor_factors(
    euler_deg: np.ndarray,
    load_direction=(0.0, 0.0, 1.0),
    family: str = "fcc",
) -> TaylorResult:
    """Full-constraints Taylor factor under uniaxial tension, per pixel.

    Args:
        euler_deg: ``(..., 3)`` zxz Euler degrees (map grid or flat).
        load_direction: sample-frame tensile axis; the imposed strain is the
            isochoric uniaxial increment ``(3/2)(d̂d̂ᵀ − I/3)`` (unit von
            Mises equivalent).
        family: slip family (`crystal.schmid.SLIP_FAMILIES`).

    Returns:
        TaylorResult with the M map and the active-vertex index.
    """
    euler = np.asarray(euler_deg, np.float32)
    if euler.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) Euler angles, got {euler.shape}")
    d = np.asarray(load_direction, np.float64)
    norm = np.linalg.norm(d)
    if d.shape != (3,) or norm == 0:
        raise ValueError(f"load_direction must be a nonzero 3-vector, got {d}")
    d = d / norm
    verts = _vertices_dev5(family)  # (V, 5)
    eps_s = 1.5 * (np.outer(d, d) - np.eye(3) / 3.0)  # unit-von-Mises strain
    from latice_tpu_torch.utils.polefigure import _euler_zxz_to_matrix_np

    g = _euler_zxz_to_matrix_np(
        euler.reshape(-1, 3).astype(np.float64)
    )  # (N, 3, 3) sample -> crystal
    eps_c = np.einsum("nij,jk,nlk->nil", g, eps_s, g)  # g ε gᵀ
    work = _to_dev5(eps_c) @ verts.T  # (N, V) σ* : ε via the orthonormal basis
    vertex = work.argmax(axis=1)
    m = work[np.arange(len(work)), vertex]
    return TaylorResult(
        factor=m.reshape(euler.shape[:-1]),
        vertex=vertex.astype(np.int32).reshape(euler.shape[:-1]),
    )
