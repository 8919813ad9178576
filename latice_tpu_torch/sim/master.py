"""Master-pattern rendering: dictionary patterns by lookup into a master.

The port of ``latice_tpu.sim.master``. A *master pattern* is the diffraction
intensity for every scattering direction, simulated once per phase and
voltage (a dynamical Bloch-wave code, or `make_kinematical_master`); any
detector pattern is a projection of it. `render_from_master` rotates each
pixel's direction into the crystal frame and interpolates the master there;
`master_from_patterns` runs the other way and learns a master from indexed
patterns.

Convention (the JAX package's): the master is a square image of the
**north hemisphere** (z >= 0, crystal frame) through the azimuthal
equal-area (Lambert) map

    X = x * sqrt(2 / (1 + z)),   Y = y * sqrt(2 / (1 + z))

scaled so the image's inscribed circle (radius ``(N-1)/2`` px) is the
equator (|XY| = sqrt(2)); the row index grows with -Y, the column with +X.
Southern directions use the antipode, right for every Laue group. Masters
in the *square* Lambert layout (EMsoft-style) are imported once with
`resample_square_lambert`.

The Lambert maps and `make_kinematical_master` are host float64 numpy, as
in the JAX package. The JAX package renders and deposits on the host too (a
per-pixel gather is the slowest memory pattern of a TPU); on a GPU a gather
is cheap, so here both run on the device:

* `render_from_master`: the bilinear lookup is an explicit four-corner
  gather from the flattened master, in float32 as in the JAX package; the
  Lambert coordinates are taken in float64 from float32 crystal-frame
  directions, as there.
* `master_from_patterns`: the bilinear deposit is ``index_add_`` in
  float64 (the JAX package's ``np.add.at`` precision). Atomic adds land in
  an order of their own, so a deposit is held to the host's within a
  tolerance, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.sim.geometry import DetectorGeometry, pixel_directions
from latice_tpu_torch.sim.kinematical import Reflectors, cubic_reflectors

__all__ = [
    "directions_to_lambert",
    "lambert_to_directions",
    "make_kinematical_master",
    "master_from_patterns",
    "render_from_master",
    "resample_square_lambert",
    "square_lambert_to_directions",
]

_SQRT2 = math.sqrt(2.0)


def directions_to_lambert(d: np.ndarray) -> np.ndarray:
    """Unit directions (..., 3) → equal-area coordinates (..., 2), using the
    NORTH-hemisphere image of each direction (antipode for z < 0)."""
    d = np.asarray(d, np.float64)
    d = np.where(d[..., 2:3] < 0, -d, d)
    a = np.sqrt(2.0 / np.clip(1.0 + d[..., 2], 1e-12, None))
    return np.stack([d[..., 0] * a, d[..., 1] * a], axis=-1)


def lambert_to_directions(xy: np.ndarray) -> np.ndarray:
    """Equal-area coordinates (..., 2) → north-hemisphere unit directions."""
    xy = np.asarray(xy, np.float64)
    r2 = np.sum(xy * xy, axis=-1)
    # |XY|^2 = 2(1-z) <= 2 on the hemisphere; clip for edge pixels.
    z = 1.0 - 0.5 * np.clip(r2, 0.0, 2.0)
    f = np.sqrt(np.clip(1.0 - r2 / 4.0, 0.0, None))
    return np.stack([xy[..., 0] * f, xy[..., 1] * f, z], axis=-1)


def square_lambert_to_directions(ab: np.ndarray) -> np.ndarray:
    """Square-Lambert coordinates (..., 2) in [-1, 1]² → north-hemisphere
    unit directions: the concentric square↔disc map (Shirley–Chiu) composed
    with this module's azimuthal equal-area projection (Roşca's map, the
    layout EMsoft stores masters in). +a along +X, +b along +Y."""
    ab = np.asarray(ab, np.float64)
    a, b = ab[..., 0], ab[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        a_dom = np.abs(a) > np.abs(b)
        r = np.where(a_dom, a, b)
        phi = np.where(
            a_dom,
            (np.pi / 4.0) * np.where(a != 0, b / np.where(a == 0, 1, a), 0.0),
            np.pi / 2.0 - (np.pi / 4.0) * np.where(b != 0, a / np.where(b == 0, 1, b), 0.0),
        )
    u = r * np.cos(phi)
    v = r * np.sin(phi)
    return lambert_to_directions(np.stack([u, v], axis=-1) * np.sqrt(2.0))


def _directions_to_square_lambert(d: np.ndarray) -> np.ndarray:
    """Inverse of `square_lambert_to_directions` (north image of each
    direction), used by the resampler."""
    xy = directions_to_lambert(d) / np.sqrt(2.0)  # disc of radius 1
    u, v = xy[..., 0], xy[..., 1]
    r = np.hypot(u, v)
    phi = np.arctan2(v, u)
    phi = np.where(phi < -np.pi / 4.0, phi + 2.0 * np.pi, phi)
    four_over_pi = 4.0 / np.pi
    a = np.select(
        [phi < np.pi / 4.0, phi < 3.0 * np.pi / 4.0, phi < 5.0 * np.pi / 4.0],
        [r, r * four_over_pi * (np.pi / 2.0 - phi), -r],
        default=r * four_over_pi * (phi - 3.0 * np.pi / 2.0),
    )
    b = np.select(
        [phi < np.pi / 4.0, phi < 3.0 * np.pi / 4.0, phi < 5.0 * np.pi / 4.0],
        [r * four_over_pi * phi, r, -r * four_over_pi * (phi - np.pi)],
        default=-r,
    )
    return np.stack([a, b], axis=-1)


def resample_square_lambert(square: np.ndarray, size: int | None = None) -> np.ndarray:
    """Convert a square-Lambert master to this module's circular equal-area
    layout (what `render_from_master` consumes): a one-time host bilinear
    resample. The source's center is the pole and its boundary the equator;
    its row grows with -b and its column with +a.

    Args:
        square: ``(N, N)`` square-Lambert master.
        size: output edge (default: the input's).

    Returns:
        ``(size, size)`` float32 master in the circular layout.
    """
    m = np.asarray(square, np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1] or m.shape[0] < 3:
        raise ValueError(f"square master must be (N, N) with N >= 3; got {m.shape}")
    n_src = m.shape[0]
    size = size or n_src
    half = (size - 1) / 2.0
    ij = (np.arange(size, dtype=np.float64) - half) / half
    x, y = np.meshgrid(ij, -ij, indexing="xy")  # row grows with -Y
    d = lambert_to_directions(np.stack([x, y], axis=-1) * np.sqrt(2.0))
    ab = _directions_to_square_lambert(d)
    half_src = (n_src - 1) / 2.0
    col = np.clip(ab[..., 0] * half_src + half_src, 0.0, n_src - 1.0)
    row = np.clip(-ab[..., 1] * half_src + half_src, 0.0, n_src - 1.0)
    r0 = np.floor(row).astype(np.int64)
    c0 = np.floor(col).astype(np.int64)
    r1 = np.minimum(r0 + 1, n_src - 1)
    c1 = np.minimum(c0 + 1, n_src - 1)
    fr = row - r0
    fc = col - c0
    out = (
        m[r0, c0] * (1 - fr) * (1 - fc)
        + m[r0, c1] * (1 - fr) * fc
        + m[r1, c0] * fr * (1 - fc)
        + m[r1, c1] * fr * fc
    )
    return out.astype(np.float32)


def make_kinematical_master(
    size: int = 513, reflectors: Reflectors | None = None, edge_frac: float = 0.25
) -> np.ndarray:
    """This package's band model rendered onto the master grid (host
    float64): the consistency anchor of `render_from_master`, and a usable
    master where no dynamical simulation is at hand."""
    reflectors = reflectors or cubic_reflectors()
    half = (size - 1) / 2.0
    ij = (np.arange(size, dtype=np.float64) - half) / half  # [-1, 1]
    x, y = np.meshgrid(ij, -ij, indexing="xy")  # row grows with -Y
    d = lambert_to_directions(np.stack([x, y], axis=-1) * np.sqrt(2.0))
    sines = d @ reflectors.normals.astype(np.float64).T  # (N, N, K)
    halfw = reflectors.sin_theta.astype(np.float64)
    soft = np.maximum(halfw * edge_frac, 1e-6)
    profile = 1.0 / (1.0 + np.exp(-(halfw - np.abs(sines)) / soft))
    img = profile @ reflectors.intensity.astype(np.float64)
    return img.astype(np.float32)


def _rotation_matrices(orientations: np.ndarray) -> np.ndarray:
    """``(B, 3, 3)`` float64 crystal→detector matrices of ``(B, 4)``
    scalar-first quaternions or ``(B, 3)`` zxz Euler degrees (scipy, as the
    JAX package converts them)."""
    from scipy.spatial.transform import Rotation as R

    o = np.asarray(orientations, np.float64)
    if o.ndim == 2 and o.shape[1] == 3:
        rots = R.from_euler("zxz", o, degrees=True)
    elif o.ndim == 2 and o.shape[1] == 4:
        rots = R.from_quat(np.roll(o, -1, axis=1))  # scalar-first -> xyzw
    else:
        raise ValueError(f"expected (B, 4) quaternions or (B, 3) Euler deg, got {o.shape}")
    return rots.as_matrix()


def _lambert_xy(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`directions_to_lambert` on a tensor: the equal-area ``(X, Y)`` of
    each unit direction's north image (antipode for z < 0)."""
    d = torch.where(d[..., 2:3] < 0, -d, d)
    a = torch.sqrt(2.0 / torch.clamp(1.0 + d[..., 2], min=1e-12))
    return d[..., 0] * a, d[..., 1] * a


def _corners(x: torch.Tensor, y: torch.Tensor, n: int):
    """Bilinear corners of Lambert coordinates ``(x, y)`` on an ``n``-pixel
    master: ``(r0, c0, r1, c1, fr, fc)`` with int64 indices and fractions in
    the coordinates' dtype."""
    half = (n - 1) / 2.0
    col = torch.clamp(x / _SQRT2 * half + half, 0.0, n - 1.0)
    row = torch.clamp(-y / _SQRT2 * half + half, 0.0, n - 1.0)
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    fr = row - r0
    fc = col - c0
    r0, c0 = r0.long(), c0.long()
    return r0, c0, torch.clamp(r0 + 1, max=n - 1), torch.clamp(c0 + 1, max=n - 1), fr, fc


def _bilinear(flat: torch.Tensor, n: int, r0, c0, r1, c1, fr, fc) -> torch.Tensor:
    """Four-corner gather from a flattened ``(n*n,)`` image, weighted as the
    JAX package sums it."""
    return (
        flat[r0 * n + c0] * (1 - fr) * (1 - fc)
        + flat[r0 * n + c1] * (1 - fr) * fc
        + flat[r1 * n + c0] * fr * (1 - fc)
        + flat[r1 * n + c1] * fr * fc
    )


def _to_crystal(rot: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``d_c[b, p] = R_bᵀ d_p``: detector directions ``(P, 3)`` into each
    crystal frame, ``(B, P, 3)``, summed over j in order (no matmul, so no
    TF32 on the card)."""
    return sum(dirs[None, :, j, None] * rot[:, None, j, :] for j in range(3))


@torch.inference_mode()
def render_from_master(
    master: np.ndarray,
    orientations: np.ndarray,
    geometry: DetectorGeometry | None = None,
    normalize: bool = True,
    chunk: int = 256,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Render detector patterns by bilinear lookup into a master pattern.

    Args:
        master: ``(N, N)`` north-hemisphere master in the module's
            equal-area convention.
        orientations: ``(B, 4)`` scalar-first quaternions (crystal→detector)
            or ``(B, 3)`` zxz Euler degrees, as `simulate_patterns` takes.
        geometry: detector description.
        normalize: min-max normalize each pattern to [0, 1].
        chunk: orientations per device pass (bounds the ``(chunk, P)``
            intermediates).
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(B, H, W)`` float32 host patterns.
    """
    m = np.asarray(master, np.float32)
    if m.ndim != 2 or m.shape[0] != m.shape[1] or m.shape[0] < 3:
        raise ValueError(f"master must be square (N, N), N >= 3; got {m.shape}")
    rot_np = _rotation_matrices(orientations).astype(np.float32)
    dev = resolve_device(device)
    geometry = geometry or DetectorGeometry()
    h, w = geometry.shape
    dirs = torch.from_numpy(pixel_directions(geometry).reshape(-1, 3).astype(np.float32)).to(dev)
    flat = torch.from_numpy(m.reshape(-1)).to(dev)
    rot = torch.from_numpy(rot_np).to(dev)
    n = m.shape[0]
    b = len(rot)
    out = torch.empty((b, h * w), dtype=torch.float32, device=dev)
    for start in range(0, b, chunk):
        d_c = _to_crystal(rot[start : start + chunk], dirs)
        # Lambert coordinates in float64 from the float32 directions, then
        # float32, as the JAX package takes them.
        x, y = _lambert_xy(d_c.double())
        r0, c0, r1, c1, fr, fc = _corners(x.float(), y.float(), n)
        out[start : start + len(d_c)] = _bilinear(flat, n, r0, c0, r1, c1, fr, fc)
    if normalize:
        lo = out.amin(dim=1, keepdim=True)
        hi = out.amax(dim=1, keepdim=True)
        out = (out - lo) / torch.clamp(hi - lo, min=1e-8)
    return out.reshape(b, h, w).cpu().numpy()


@torch.inference_mode()
def master_from_patterns(
    patterns: np.ndarray,
    orientations: np.ndarray,
    geometry: DetectorGeometry | None = None,
    size: int = 257,
    group: str | None = None,
    chunk: int = 256,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Learn a master pattern FROM indexed patterns: the inverse of
    `render_from_master`.

    Every pixel of every pattern samples the master at crystal direction
    ``Rᵀ d``, so an indexed scan (orientations from any plane) back-projects
    into a master estimate by bilinear deposit on the equal-area grid.

    Args:
        patterns: ``(B, H, W)`` detector patterns (any intensity scale; each
            is min-max normalized before the deposit, as `render_from_master`
            normalizes).
        orientations: ``(B, 4)`` scalar-first quaternions or ``(B, 3)`` zxz
            Euler degrees (crystal→detector).
        geometry: detector description the patterns were captured with.
        size: output master edge.
        group: optional proper point group (`crystal.ROTATION_GROUPS`): the
            accumulated value and weight grids are orbit-averaged over it,
            which also fills directions the scan never sampled.
        chunk: patterns per deposit pass.
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(master (size, size) float32 in [0, 1], weights (size, size)
        float64)``: ``weights`` is the bilinear hit mass per bin after the
        symmetrization; bins without weight carry the covered mean.
    """
    from scipy.spatial.transform import Rotation as R

    x = np.asarray(patterns)
    if x.ndim != 3:
        raise ValueError(f"expected (B, H, W) patterns, got {x.shape}")
    rot_np = _rotation_matrices(orientations)
    if len(rot_np) != len(x):
        raise ValueError(f"{len(x)} patterns but {len(rot_np)} orientations")
    if size < 3:
        raise ValueError(f"size must be >= 3, got {size}")
    geometry = geometry or DetectorGeometry()
    h, w = geometry.shape
    if x.shape[1:] != (h, w):
        raise ValueError(
            f"patterns are {x.shape[1]}x{x.shape[2]} but the geometry is {h}x{w}"
        )
    sym = None
    if group is not None:
        from latice_tpu_torch.crystal.symmetry import ROTATION_GROUPS

        if group not in ROTATION_GROUPS:
            raise ValueError(
                f"unknown point group {group!r}; choose from {sorted(ROTATION_GROUPS)}"
            )
        sym = R.from_quat(np.roll(np.asarray(ROTATION_GROUPS[group]), -1, axis=1)).as_matrix()
    dev = resolve_device(device)
    f64 = torch.float64
    dirs = torch.from_numpy(pixel_directions(geometry).reshape(-1, 3).astype(np.float64)).to(dev)
    rot = torch.from_numpy(rot_np).to(dev)
    acc = torch.zeros(size * size, dtype=f64, device=dev)
    wacc = torch.zeros(size * size, dtype=f64, device=dev)
    for start in range(0, len(x), chunk):
        flat = torch.from_numpy(np.asarray(x[start : start + chunk])).to(dev).reshape(
            -1, h * w).to(f64)
        lo = flat.amin(dim=1, keepdim=True)
        hi = flat.amax(dim=1, keepdim=True)
        vc = ((flat - lo) / torch.clamp(hi - lo, min=1e-12)).reshape(-1)
        # Detector → crystal frame (the inverse of the render's lookup).
        d_c = torch.einsum("bji,pj->bpi", rot[start : start + chunk], dirs).reshape(-1, 3)
        r0, c0, r1, c1, fr, fc = _corners(*_lambert_xy(d_c), size)
        for rr, cc, ww in (
            (r0, c0, (1 - fr) * (1 - fc)),
            (r0, c1, (1 - fr) * fc),
            (r1, c0, fr * (1 - fc)),
            (r1, c1, fr * fc),
        ):
            idx = rr * size + cc
            acc.index_add_(0, idx, vc * ww)
            wacc.index_add_(0, idx, ww)

    if sym is not None:
        # Orbit-average the accumulated grids: for each bin's direction d,
        # sum the (value·weight, weight) samples at every s·d, as if each
        # pattern were deposited |G| times.
        half = (size - 1) / 2.0
        jj, ii = np.meshgrid(np.arange(size), np.arange(size))
        gx = (jj - half) / half * np.sqrt(2.0)
        gy = -(ii - half) / half * np.sqrt(2.0)
        # Corner pixels beyond the equator circle are not directions; keep
        # them out rather than alias equator values into them.
        valid = torch.from_numpy((gx * gx + gy * gy <= 2.0).reshape(-1)).to(dev)
        grid_d = torch.from_numpy(
            lambert_to_directions(np.stack([gx, gy], axis=-1)).reshape(-1, 3)).to(dev)
        acc_s = torch.zeros_like(acc)
        wacc_s = torch.zeros_like(wacc)
        for s in torch.from_numpy(sym).to(dev):
            corners = _corners(*_lambert_xy(grid_d @ s.T), size)
            acc_s += _bilinear(acc, size, *corners)
            wacc_s += _bilinear(wacc, size, *corners)
        acc, wacc = acc_s * valid, wacc_s * valid

    covered = wacc > 1e-9
    if not bool(covered.any()):
        raise ValueError("no master bins received any deposit")
    master = torch.zeros_like(acc)
    master[covered] = acc[covered] / wacc[covered]
    master[~covered] = master[covered].mean()
    lo, hi = master.min(), master.max()
    master = (master - lo) / torch.clamp(hi - lo, min=1e-12)
    return (master.reshape(size, size).float().cpu().numpy(),
            wacc.reshape(size, size).cpu().numpy())
