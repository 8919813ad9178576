"""CSL grain-boundary classification: Σ3 twins and friends under the Brandon
criterion (the port of ``latice_tpu/crystal/csl.py``).

A cubic CSL misorientation has an exact integer quaternion whose squared
norm's odd part is Σ (Grimmer). A boundary with crystal-frame
misorientation ``Δq = qa⁻¹ ⊗ qb`` is Σ when its deviation from the
two-sided symmetry orbit of ``qΣ`` is within ``15°/√Σ`` (Brandon); the
lowest Σ wins. The orbits are built and deduplicated on the host in f64
numpy, copied, so they equal the JAX package's bitwise; the per-edge
deviation ``2·arccos(max |Δq · orbitᵀ|)`` runs on the device, tiled by map
rows (see `_deviation_fields`). The identity's orbit (the point group)
rides along as "Σ1", so the same product gives the plain disorientation
used for the boundary threshold.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import from_euler_zxz_deg, quat_inv, quat_mul
from latice_tpu_torch.crystal.symmetry import symmetry_quats
from latice_tpu_torch.device import full_f32_matmul, resolve_device

__all__ = [
    "CSL_CUBIC",
    "CslBoundaryMaps",
    "brandon_tolerance_deg",
    "classify_csl_boundaries",
    "csl_axis_angle",
    "csl_fractions",
    "csl_orbit",
    "csl_rotation",
    "sigma_value",
]

#: Label codes in `CslBoundaryMaps`: edges below the boundary threshold.
NOT_BOUNDARY = -2
#: Boundary edges matching no requested Σ ("random" boundaries).
RANDOM_BOUNDARY = -1

#: Bytes of the largest per-tile intermediate, the ``(edges, nS·K)`` score
#: matrix. The full table has 22 orbits padded to 878 images: untiled, a
#: 1024x1024 map's east edges alone would need ~81 GB.
TILE_BYTES = 1 << 30

# Exact integer quaternions (w, x, y, z) of the cubic CSL misorientations,
# Σ3–Σ29. Σ = odd part of the squared norm; angle = 2·arccos(w/‖q‖);
# axis = (x, y, z). The a/b variants share one Σ.
CSL_CUBIC: dict[str, tuple[int, int, int, int]] = {
    "3": (3, 1, 1, 1),      # 60.00° ⟨111⟩ — annealing twin
    "5": (3, 1, 0, 0),      # 36.87° ⟨100⟩
    "7": (5, 1, 1, 1),      # 38.21° ⟨111⟩
    "9": (4, 1, 1, 0),      # 38.94° ⟨110⟩
    "11": (3, 1, 1, 0),     # 50.48° ⟨110⟩
    "13a": (5, 1, 0, 0),    # 22.62° ⟨100⟩
    "13b": (7, 1, 1, 1),    # 27.80° ⟨111⟩
    "15": (5, 2, 1, 0),     # 48.19° ⟨210⟩
    "17a": (4, 1, 0, 0),    # 28.07° ⟨100⟩
    "17b": (5, 2, 2, 1),    # 61.93° ⟨221⟩
    "19a": (6, 1, 1, 0),    # 26.53° ⟨110⟩
    "19b": (4, 1, 1, 1),    # 46.83° ⟨111⟩
    "21a": (9, 1, 1, 1),    # 21.79° ⟨111⟩
    "21b": (6, 2, 1, 1),    # 44.42° ⟨211⟩
    "23": (9, 3, 1, 1),     # 40.46° ⟨311⟩
    "25a": (7, 1, 0, 0),    # 16.26° ⟨100⟩
    "25b": (9, 3, 3, 1),    # 51.68° ⟨331⟩
    "27a": (5, 1, 1, 0),    # 31.59° ⟨110⟩
    "27b": (7, 2, 1, 0),    # 35.43° ⟨210⟩
    "29a": (5, 2, 0, 0),    # 43.60° ⟨100⟩
    "29b": (7, 2, 2, 1),    # 46.40° ⟨221⟩
}


def sigma_value(sigma: str) -> int:
    """Σ of a table entry, recomputed as the odd part of the squared norm."""
    q = CSL_CUBIC[str(sigma)]
    n = sum(c * c for c in q)
    while n % 2 == 0:
        n //= 2
    return n


def csl_rotation(sigma: str) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a CSL misorientation, float64."""
    q = np.asarray(CSL_CUBIC[str(sigma)], dtype=np.float64)
    return q / np.linalg.norm(q)


def csl_axis_angle(sigma: str) -> tuple[np.ndarray, float]:
    """(integer axis, angle in degrees) of a CSL entry, the published form."""
    w, x, y, z = CSL_CUBIC[str(sigma)]
    norm = math.sqrt(w * w + x * x + y * y + z * z)
    axis = np.asarray((x, y, z), dtype=np.int64)
    g = math.gcd(math.gcd(abs(x), abs(y)), abs(z)) or 1
    return axis // g, math.degrees(2.0 * math.acos(w / norm))


def brandon_tolerance_deg(sigma: str, base_deg: float = 15.0) -> float:
    """Brandon criterion: a boundary is Σ within ``base/√Σ`` degrees."""
    return base_deg / math.sqrt(sigma_value(sigma))


def _qmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, numpy, broadcasting over leading axes."""
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _host_symmetry(group: str) -> np.ndarray:
    """A point group's operators as the JAX package's host code sees them:
    the float32 table, widened to float64."""
    return symmetry_quats(group).to(torch.float64).numpy()


def csl_orbit(q: np.ndarray, group: str = "432") -> np.ndarray:
    """Deduplicated two-sided symmetry orbit ``{s1 ⊗ q' ⊗ s2}`` of ``q``
    and ``q⁻¹`` (an edge sees Δq or Δq⁻¹ by scan direction), canonical sign,
    unit rows."""
    sym = _host_symmetry(group)
    qs = np.stack([q, q * np.asarray([1.0, -1.0, -1.0, -1.0])])
    right = _qmul_np(qs[:, None, :], sym[None, :, :])  # (2, S, 4)
    orbit = _qmul_np(sym[None, :, None, :], right[:, None, :, :])
    orbit = orbit.reshape(-1, 4)
    flip = orbit[:, :1] < 0
    orbit = np.where(flip, -orbit, orbit)
    orbit = np.unique(np.round(orbit, 9), axis=0)
    return orbit / np.linalg.norm(orbit, axis=-1, keepdims=True)


class CslBoundaryMaps(NamedTuple):
    """Per-edge CSL labels over an (H, W) orientation grid.

    ``east[i, j]`` labels the edge (i, j)–(i, j+1), ``south`` the edge to
    (i+1, j): an index into ``sigmas``, ``RANDOM_BOUNDARY`` (-1) or
    ``NOT_BOUNDARY`` (-2, also the last column / row).
    """

    east: np.ndarray
    south: np.ndarray
    sigmas: tuple[str, ...]


def _edge_deviations(d: torch.Tensor, table: torch.Tensor, mask: torch.Tensor, ns: int) -> torch.Tensor:
    """``(E, 4)`` misorientations → ``(E, nS)`` deviation degrees from each
    orbit of the ``(4, nS·K)`` table."""
    with full_f32_matmul():
        dots = d @ table
    dots.abs_().mul_(mask)
    m = dots.view(len(d), ns, -1).amax(dim=-1)
    return 2.0 * torch.rad2deg(torch.arccos(torch.clamp(m, 0.0, 1.0)))


@torch.no_grad()
def _deviation_fields(euler_deg: torch.Tensor, orbits: torch.Tensor, valid: torch.Tensor):
    """(H, W, 3) Euler grid → per-edge deviation (degrees) from each orbit:
    east (H, W-1, nS) and south (H-1, W, nS).

    ``orbits`` is (nS, K, 4), zero-padded; ``valid`` (nS, K) marks real
    rows. Every edge's maximum is independent, so the map is taken in
    blocks of rows sized to keep the ``(edges, nS·K)`` score matrix within
    `TILE_BYTES`; tiling changes no result.
    """
    h, w, _ = euler_deg.shape
    q = from_euler_zxz_deg(euler_deg)
    ns, k, _ = orbits.shape
    table = orbits.reshape(ns * k, 4).T.contiguous()
    mask = valid.reshape(ns * k).to(q.dtype)
    rows = max(1, TILE_BYTES // (w * ns * k * 4))

    def field(qa, qb):
        out = []
        for r0 in range(0, qa.shape[0], rows):
            d = quat_mul(quat_inv(qa[r0:r0 + rows]), qb[r0:r0 + rows])
            out.append(_edge_deviations(d.reshape(-1, 4), table, mask, ns).view(*d.shape[:-1], ns))
        return torch.cat(out)

    return field(q[:, :-1], q[:, 1:]), field(q[:-1, :], q[1:, :])


def classify_csl_boundaries(
    euler_deg: np.ndarray,
    group: str = "432",
    sigmas: Sequence[str] | None = None,
    boundary_threshold_deg: float = 5.0,
    brandon_base_deg: float = 15.0,
    device=None,
) -> CslBoundaryMaps:
    """Label every boundary edge of an ``(H, W, 3)`` Euler-degree map with
    its CSL type (`CslBoundaryMaps` of int16 labels, host arrays).

    Only the cubic group ``"432"`` has the built-in Σ table. ``sigmas``
    picks `CSL_CUBIC` keys (default: all); ties go to the lowest Σ, then
    'a' before 'b'. Edges below ``boundary_threshold_deg`` are
    `NOT_BOUNDARY`; the tolerance per Σ is ``brandon_base_deg/√Σ``.
    """
    if group != "432":
        raise ValueError(
            "the built-in CSL table is cubic (Grimmer Σ3–Σ29); "
            f"group {group!r} has no standard Σ classification here"
        )
    euler = np.asarray(euler_deg, dtype=np.float32)
    if euler.ndim != 3 or euler.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) Euler grid, got {euler.shape}")
    if euler.shape[0] < 2 or euler.shape[1] < 2:
        raise ValueError("orientation map must be at least 2x2")
    names = list(sigmas) if sigmas is not None else list(CSL_CUBIC)
    for n in names:
        if str(n) not in CSL_CUBIC:
            raise ValueError(f"unknown Σ {n!r}; known: {', '.join(CSL_CUBIC)}")
    names = sorted((str(n) for n in names), key=lambda s: (sigma_value(s), s))
    dev = resolve_device(device)

    # Row 0 is Σ1 (the identity's orbit): its deviation is the plain
    # disorientation, which the boundary threshold reads.
    orbit_list = [csl_orbit(np.asarray([1.0, 0.0, 0.0, 0.0]), group)]
    orbit_list += [csl_orbit(csl_rotation(n), group) for n in names]
    kmax = max(len(o) for o in orbit_list)
    orbits = np.zeros((len(orbit_list), kmax, 4), np.float32)
    valid = np.zeros((len(orbit_list), kmax), bool)
    for i, o in enumerate(orbit_list):
        orbits[i, : len(o)] = o
        valid[i, : len(o)] = True

    east_dev, south_dev = _deviation_fields(
        torch.as_tensor(euler, device=dev),
        torch.as_tensor(orbits, device=dev),
        torch.as_tensor(valid, device=dev),
    )
    tol = np.asarray([brandon_tolerance_deg(n, brandon_base_deg) for n in names], np.float32)

    def label(dev_field):
        dev_field = dev_field.cpu().numpy()
        disorient = dev_field[..., 0]
        within = dev_field[..., 1:] <= tol
        first = np.argmax(within, axis=-1)
        out = np.where(within.any(axis=-1), first, RANDOM_BOUNDARY)
        out = np.where(disorient >= boundary_threshold_deg, out, NOT_BOUNDARY)
        return out.astype(np.int16)

    east = np.full(euler.shape[:2], NOT_BOUNDARY, np.int16)
    south = np.full(euler.shape[:2], NOT_BOUNDARY, np.int16)
    east[:, :-1] = label(east_dev)
    south[:-1, :] = label(south_dev)
    return CslBoundaryMaps(east, south, tuple(names))


def csl_fractions(maps: CslBoundaryMaps) -> dict[str, float]:
    """Number fraction of boundary edges per Σ, plus ``"random"``."""
    labels = np.concatenate([maps.east.ravel(), maps.south.ravel()])
    boundary = labels[labels != NOT_BOUNDARY]
    total = len(boundary)
    if total == 0:
        return {"random": 0.0, **{n: 0.0 for n in maps.sigmas}}
    out = {"random": float((boundary == RANDOM_BOUNDARY).sum() / total)}
    for i, n in enumerate(maps.sigmas):
        out[n] = float((boundary == i).sum() / total)
    return out
