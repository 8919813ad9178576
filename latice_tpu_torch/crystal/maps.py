"""Orientation-map analysis: misorientation fields, KAM, grain labelling,
cleanup and per-grain statistics (the port of ``latice_tpu/crystal/maps.py``).

The split between device and host is the JAX package's: the per-pixel
disorientation field (Euler → quaternion, the minimum over every symmetry
image, both neighbour directions) runs as torch on the device; labelling
(scipy's connected components over the thresholded edge graph), KAM, the
boundary masks, the cleanup's fill loop and the f64 per-grain accumulation
stay host numpy, copied, so they equal the JAX package's bitwise on equal
fields. Inputs and outputs are host numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import (
    from_euler_zxz_deg,
    misorientation_angle,
    quat_mul,
    to_euler_zxz_deg,
)
from latice_tpu_torch.crystal.symmetry import (
    nearest_symmetry_equivalent,
    symmetry_quats,
    symmetry_reduced_misorientation,
)
from latice_tpu_torch.device import resolve_device

__all__ = [
    "GrainStatistics",
    "MisorientationMaps",
    "boundary_disorientation_angles",
    "clean_orientation_map",
    "misorientation_maps",
    "misorientation_maps_multiphase",
    "kernel_average_misorientation",
    "grain_boundary_mask",
    "grain_statistics",
    "label_grains",
    "random_disorientation_angles",
]

#: Sentinel disorientation (degrees) of edges joining pixels of different
#: phases: above any physical disorientation (at most 180), so every phase
#: boundary is a grain boundary at any threshold.
PHASE_BOUNDARY_DEG = 999.0


class MisorientationMaps(NamedTuple):
    """Neighbour disorientation fields over an (H, W) orientation grid.

    ``east[i, j]`` is the symmetry-reduced misorientation (degrees) between
    pixel (i, j) and (i, j+1); ``south[i, j]`` between (i, j) and (i+1, j).
    The last column of ``east`` and last row of ``south`` are 0.
    """

    east: np.ndarray
    south: np.ndarray


def _reduced_deg(qa: torch.Tensor, qb: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """``min_s angle(qa, s ⊗ qb)`` in degrees, ``(..., 4)`` x ``(..., 4)``."""
    imgs = quat_mul(sym, qb[..., None, :])
    return torch.rad2deg(misorientation_angle(qa[..., None, :], imgs).amin(dim=-1))


@torch.no_grad()
def _disorientation_fields(euler_deg: torch.Tensor, sym: torch.Tensor):
    """(H, W, 3) Euler degrees → (east, south) disorientation fields in
    degrees, zero-padded on the last column / row. At 1024x1024 and 24
    operators the symmetry images are ~0.4 GB per direction."""
    q = from_euler_zxz_deg(euler_deg)
    east = torch.nn.functional.pad(_reduced_deg(q[:, :-1], q[:, 1:], sym), (0, 1))
    south = torch.nn.functional.pad(_reduced_deg(q[:-1, :], q[1:, :], sym), (0, 0, 0, 1))
    return east, south


def _check_grid(euler: np.ndarray) -> None:
    if euler.ndim != 3 or euler.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) Euler grid, got {euler.shape}")
    if euler.shape[0] < 2 or euler.shape[1] < 2:
        raise ValueError("orientation map must be at least 2x2")


def misorientation_maps(euler_deg: np.ndarray, group: str = "432", device=None) -> MisorientationMaps:
    """Symmetry-reduced neighbour misorientation fields of an ``(H, W, 3)``
    zxz Euler-degree map in point group ``group``; float32 ``(H, W)`` east and
    south fields on the host."""
    euler = np.asarray(euler_deg, dtype=np.float32)
    _check_grid(euler)
    dev = resolve_device(device)
    sym = symmetry_quats(group, device=dev)
    east, south = _disorientation_fields(torch.as_tensor(euler, device=dev), sym)
    return MisorientationMaps(east.cpu().numpy(), south.cpu().numpy())


def misorientation_maps_multiphase(
    euler_deg: np.ndarray,
    phases: np.ndarray,
    groups: list[str],
    device=None,
) -> MisorientationMaps:
    """Disorientation fields of a multi-phase orientation map.

    Same-phase edges are reduced with that phase's point group; cross-phase
    edges, and every edge touching a negative (unindexed) phase id, get
    `PHASE_BOUNDARY_DEG`, so they always segment as grain boundaries.
    ``groups`` names the point group of each phase id.
    """
    ph = np.asarray(phases)
    euler = np.asarray(euler_deg)
    if ph.shape != euler.shape[:2]:
        raise ValueError(f"phases {ph.shape} does not match map {euler.shape[:2]}")
    n_phases = int(ph.max()) + 1 if ph.size else 1
    if n_phases < 1:
        n_phases = 1  # all pixels unindexed: every edge becomes a boundary
    if len(groups) < n_phases:
        raise ValueError(f"{n_phases} phase ids but only {len(groups)} groups")

    east = np.full(ph.shape, 0.0, dtype=np.float32)
    south = np.full(ph.shape, 0.0, dtype=np.float32)
    # One device field per distinct group, not per phase.
    by_group: dict[str, MisorientationMaps] = {}
    for g in set(groups[:n_phases]):
        by_group[g] = misorientation_maps(euler, group=g, device=device)
    for p in range(n_phases):
        m = by_group[groups[p]]
        sel_e = (ph[:, :-1] == p) & (ph[:, 1:] == p)
        sel_s = (ph[:-1, :] == p) & (ph[1:, :] == p)
        east[:, :-1][sel_e] = m.east[:, :-1][sel_e]
        south[:-1, :][sel_s] = m.south[:-1, :][sel_s]
    bad = ph < 0
    cross_e = (ph[:, :-1] != ph[:, 1:]) | bad[:, :-1] | bad[:, 1:]
    cross_s = (ph[:-1, :] != ph[1:, :]) | bad[:-1, :] | bad[1:, :]
    east[:, :-1][cross_e] = PHASE_BOUNDARY_DEG
    south[:-1, :][cross_s] = PHASE_BOUNDARY_DEG
    return MisorientationMaps(east, south)


def kernel_average_misorientation(maps: MisorientationMaps, threshold_deg: float = 5.0) -> np.ndarray:
    """First-neighbour KAM: per pixel, the mean disorientation to its
    in-grid 4-neighbours below ``threshold_deg`` (0 where there is none)."""
    east, south = maps
    h, w = east.shape
    deg = np.zeros((h, w), dtype=np.float32)
    cnt = np.zeros((h, w), dtype=np.int32)
    for field, (dst_a, src_a) in (
        (east[:, :-1], (np.s_[:, :-1], np.s_[:, 1:])),
        (south[:-1, :], (np.s_[:-1, :], np.s_[1:, :])),
    ):
        ok = field < threshold_deg
        for sl in (dst_a, src_a):
            deg[sl] += np.where(ok, field, 0.0)
            cnt[sl] += ok
    return np.divide(deg, cnt, out=np.zeros_like(deg), where=cnt > 0)


def grain_boundary_mask(maps: MisorientationMaps, threshold_deg: float = 5.0) -> np.ndarray:
    """Boolean ``(H, W)`` mask of pixels with a 4-neighbour edge at or
    above ``threshold_deg``."""
    east, south = maps
    mask = np.zeros(east.shape, dtype=bool)
    e = east[:, :-1] >= threshold_deg
    s = south[:-1, :] >= threshold_deg
    mask[:, :-1] |= e
    mask[:, 1:] |= e
    mask[:-1, :] |= s
    mask[1:, :] |= s
    return mask


def boundary_disorientation_angles(maps: MisorientationMaps, threshold_deg: float = 5.0) -> np.ndarray:
    """Flat array of the boundary edges' disorientations (degrees): every
    edge at or above ``threshold_deg``, phase-boundary sentinels excluded."""
    east, south = maps
    vals = np.concatenate([east[:, :-1].ravel(), south[:-1, :].ravel()])
    return vals[(vals >= threshold_deg) & (vals < PHASE_BOUNDARY_DEG)]


def random_disorientation_angles(
    group: str = "432", n: int = 100_000, seed: int = 0, device=None
) -> np.ndarray:
    """Disorientation angles (degrees) of random orientation pairs: the
    Mackenzie distribution of ``group`` by Monte Carlo. The same numpy draws
    as the JAX package (Shoemake map), reduced against the identity on the
    device."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, 3))
    q = np.stack(
        [
            np.sqrt(1 - u[:, 0]) * np.sin(2 * np.pi * u[:, 1]),
            np.sqrt(1 - u[:, 0]) * np.cos(2 * np.pi * u[:, 1]),
            np.sqrt(u[:, 0]) * np.sin(2 * np.pi * u[:, 2]),
            np.sqrt(u[:, 0]) * np.cos(2 * np.pi * u[:, 2]),
        ],
        axis=-1,
    ).astype(np.float32)
    dev = resolve_device(device)
    sym = symmetry_quats(group, device=dev)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    with torch.no_grad():
        ang = symmetry_reduced_misorientation(identity, torch.as_tensor(q, device=dev), sym)
    return np.degrees(ang.cpu().numpy())


class GrainStatistics(NamedTuple):
    """Per-grain statistics, each of length ``n_grains`` by label."""

    #: Pixel count per grain.
    sizes_px: np.ndarray
    #: Equivalent circle diameter ``2·sqrt(area/π)`` in pixels.
    equivalent_diameter_px: np.ndarray
    #: Symmetry-aware mean orientation per grain, zxz Euler degrees ``(G, 3)``.
    mean_orientation: np.ndarray
    #: Grain orientation spread: mean angle (degrees) of the grain's pixels
    #: to its mean orientation.
    gos_deg: np.ndarray


def grain_statistics(
    euler_deg: np.ndarray, labels: np.ndarray, group: str = "432", device=None
) -> GrainStatistics:
    """Size, equivalent diameter, mean orientation and GOS of every grain.

    Every pixel is snapped on the device to its crystal-side symmetry image
    nearest its grain's seed pixel (the grain's first pixel in row-major
    order, which `label_grains`' first-visit labels make the first index of
    each label); the chordal-L2 mean per grain is the leading eigenvector of
    the f64 sum of outer products on the host, as in the JAX package.
    ``euler_deg`` is ``(H, W, 3)`` or ``(N, 3)``, ``labels`` matches it.
    """
    euler = np.asarray(euler_deg, dtype=np.float32).reshape(-1, 3)
    lab = np.asarray(labels).reshape(-1)
    if len(lab) != len(euler):
        raise ValueError(f"labels ({lab.shape}) do not match orientations ({euler.shape})")
    n_grains = int(lab.max()) + 1 if lab.size else 0
    sizes = np.bincount(lab, minlength=n_grains).astype(np.int64)
    ecd = 2.0 * np.sqrt(sizes / np.pi)

    dev = resolve_device(device)
    sym = symmetry_quats(group, device=dev)
    with torch.no_grad():
        q = from_euler_zxz_deg(torch.as_tensor(euler, device=dev))
        _, seed_idx = np.unique(lab, return_index=True)
        q_host = q.cpu().numpy().astype(np.float64)
        q_seed = q_host[seed_idx][lab]
        # compose="crystal" (q ⊗ sym): physical equivalence. The
        # premultiplied images hold no near-seed image when a pixel's
        # fundamental-zone representative differs from its seed's.
        aligned = nearest_symmetry_equivalent(
            torch.as_tensor(q_seed, dtype=torch.float32, device=dev), q, sym, compose="crystal"
        ).cpu().numpy().astype(np.float64)
    flip = np.sum(aligned * q_seed, axis=-1) < 0
    aligned[flip] *= -1.0

    m = np.zeros((n_grains, 4, 4), np.float64)
    np.add.at(m, lab, aligned[:, :, None] * aligned[:, None, :])
    _, vecs = np.linalg.eigh(m)
    mean_q = vecs[..., -1]
    with torch.no_grad():
        mean_euler = to_euler_zxz_deg(
            torch.as_tensor(mean_q, dtype=torch.float32, device=dev)
        ).cpu().numpy()

    dots = np.abs(np.sum(aligned * mean_q[lab], axis=-1))
    ang = 2.0 * np.degrees(np.arccos(np.clip(dots, -1.0, 1.0)))
    gos = np.bincount(lab, weights=ang, minlength=n_grains) / np.maximum(sizes, 1)
    return GrainStatistics(
        sizes_px=sizes,
        equivalent_diameter_px=ecd.astype(np.float32),
        mean_orientation=mean_euler.astype(np.float32),
        gos_deg=gos.astype(np.float32),
    )


def clean_orientation_map(
    euler_deg: np.ndarray,
    bad: np.ndarray | None = None,
    min_grain_px: int = 0,
    group: str = "432",
    threshold_deg: float = 5.0,
    phases: np.ndarray | None = None,
    groups: list[str] | None = None,
    max_iterations: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Grain-dilation cleanup of an orientation map (OIM-style).

    Pixels in ``bad`` and members of grains under ``min_grain_px`` are
    replaced: each round every such pixel adopts the orientation (and
    phase) of its 4-neighbour whose grain is largest among the good ones,
    until all are filled or nothing changes (at most ``max_iterations``,
    default H + W). With ``phases`` (negative = unindexed, implicitly bad)
    ``groups`` gives each phase's point group. Returns ``(cleaned_euler,
    filled_mask, cleaned_phases)``; the last is None without ``phases``.
    """
    euler = np.array(euler_deg, dtype=np.float64, copy=True)
    h, w = euler.shape[:2]
    ph = None if phases is None else np.array(phases, np.int64, copy=True)
    bad_mask = np.zeros((h, w), bool) if bad is None else np.array(bad, bool)
    if ph is not None:
        if groups is None:
            raise ValueError("phases given without per-phase groups")
        bad_mask = bad_mask | (ph < 0)

    def _segment(e, p):
        if p is not None:
            return misorientation_maps_multiphase(e, p, groups, device=device)
        return misorientation_maps(e, group=group, device=device)

    labels, n_grains = label_grains(_segment(euler, ph), threshold_deg=threshold_deg)
    if min_grain_px > 1:
        sizes = np.bincount(labels.ravel(), minlength=n_grains)
        bad_mask = bad_mask | (sizes[labels] < min_grain_px)
    # Bad pixels lend nothing: goodness and grain size update as fills land.
    good = ~bad_mask
    sizes_map = np.where(good, np.bincount(labels.ravel(), minlength=n_grains)[labels], 0)
    filled = np.zeros((h, w), bool)
    limit = max_iterations if max_iterations is not None else h + w

    for _ in range(limit):
        todo = ~good
        if not todo.any():
            break
        # Neighbour grain sizes (0 where bad or off-map) in N/S/W/E order.
        n_sz = np.zeros((4, h, w), np.int64)
        n_sz[0, 1:, :] = sizes_map[:-1, :]
        n_sz[1, :-1, :] = sizes_map[1:, :]
        n_sz[2, :, 1:] = sizes_map[:, :-1]
        n_sz[3, :, :-1] = sizes_map[:, 1:]
        best = np.argmax(n_sz, axis=0)
        best_sz = np.take_along_axis(n_sz, best[None], axis=0)[0]
        fill = todo & (best_sz > 0)
        if not fill.any():
            break  # an isolated bad region with no good contact
        ii, jj = np.nonzero(fill)
        off = np.asarray([[-1, 0], [1, 0], [0, -1], [0, 1]])[best[ii, jj]]
        si, sj = ii + off[:, 0], jj + off[:, 1]
        euler[ii, jj] = euler[si, sj]
        if ph is not None:
            ph[ii, jj] = ph[si, sj]
        sizes_map[ii, jj] = sizes_map[si, sj]
        good[ii, jj] = True
        filled[ii, jj] = True
    return euler, filled, ph


def label_grains(maps: MisorientationMaps, threshold_deg: float = 5.0) -> tuple[np.ndarray, int]:
    """Grains as connected components of the edges below ``threshold_deg``
    (4-connectivity). Returns ``(labels, n_grains)``, labels ``0..n-1`` in
    row-major first-visit order."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    east, south = maps
    h, w = east.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    e_ok = east[:, :-1] < threshold_deg
    s_ok = south[:-1, :] < threshold_deg
    a = np.concatenate([idx[:, :-1][e_ok], idx[:-1, :][s_ok]])
    b = np.concatenate([idx[:, 1:][e_ok], idx[1:, :][s_ok]])
    adj = coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(n, n))
    n_grains, labels = connected_components(adj, directed=False)
    _, first = np.unique(labels, return_index=True)
    order = np.argsort(np.argsort(first))
    return order[labels].reshape(h, w).astype(np.int32), int(n_grains)
