"""Kinematical Kikuchi-band renderer: reflector tables and a batched torch
render.

The port of ``latice_tpu.sim.kinematical``. The reflector tables are the
JAX package's host numpy, copied; the render runs in torch on the device.

Physics model:

* Electron wavelength with the relativistic correction:
  ``λ[Å] = 12.2643 / sqrt(V · (1 + 0.97845e-6 · V))``.
* Reflectors from the cell's reciprocal lattice with structure-factor
  extinctions (fcc: h,k,l all even or all odd; bcc: h+k+l even; sc: all),
  every symmetry-equivalent reflector kept, so patterns are invariant under
  the crystal's point group. Bragg angle ``θ = asin(λ / 2d)``.
* Intensities ``|F|² · exp(-(s/s0)²)``, ``s = 1/(2d)``: a single-element
  falloff standing in for atomic form factors.
* A pixel with unit direction ``d`` lies in the ``hkl`` band when
  ``|d · n| < sin θ``; the profile is a sigmoid-edged top-hat between the
  two Kossel-cone traces.

Per orientation chunk the render is one batched product ``(P, 3)
directions × (B, 3, K) rotated normals``, an elementwise profile over the
``(B, P, K)`` result and a product with the ``(K,)`` intensities. Both
products run in full float32 whatever
``torch.set_float32_matmul_precision`` says (`device.full_f32_matmul`):
band edges move visibly in TF32, as they do at the TPU's default bf16
precision, which is why the JAX package runs them at ``HIGHEST``.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from latice_tpu_torch.device import full_f32_matmul, resolve_device
from latice_tpu_torch.sim.geometry import DetectorGeometry, pixel_directions

__all__ = [
    "Reflectors",
    "cubic_reflectors",
    "electron_wavelength",
    "hexagonal_reflectors",
    "reflectors_from_cell",
    "simulate_patterns",
]


def electron_wavelength(kv: float) -> float:
    """Relativistic electron wavelength in Angstrom for ``kv`` kilovolts."""
    if kv <= 0:
        raise ValueError("accelerating voltage must be positive")
    v = kv * 1e3
    return 12.2643 / math.sqrt(v * (1.0 + 0.97845e-6 * v))


@dataclasses.dataclass(frozen=True)
class Reflectors:
    """Individual reflectors: unit plane normals (crystal frame), Bragg
    sines, and kinematical weights. ``normals[k]`` and ``-normals[k]`` give
    the same band, so only one hemisphere representative is kept."""

    normals: np.ndarray  # (K, 3) float32, unit
    sin_theta: np.ndarray  # (K,) float32
    intensity: np.ndarray  # (K,) float32, max-normalized

    def __len__(self) -> int:
        return len(self.normals)


# Conventional atomic bases per cubic centering; their structure factors
# reproduce the classical extinction rules exactly (fcc: all-even/all-odd;
# bcc: h+k+l even), pinned by the test-side rule oracle.
_BASES = {
    "fcc": (
        (0.0, 0.0, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0),
    ),
    "bcc": ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5)),
    "sc": ((0.0, 0.0, 0.0),),
}


def _direct_basis(a, b, c, alpha, beta, gamma):
    """Cartesian direct-lattice vectors (rows), standard crystallographic
    setting: a1 along x, a2 in the x-y plane."""
    al, be, ga = np.radians([alpha, beta, gamma])
    cx = c * math.cos(be)
    cy = c * (math.cos(al) - math.cos(be) * math.cos(ga)) / math.sin(ga)
    cz2 = c * c - cx * cx - cy * cy
    if cz2 <= 0:
        raise ValueError(
            f"degenerate cell: ({a}, {b}, {c}, {alpha}, {beta}, {gamma})"
        )
    return np.array(
        [
            [a, 0.0, 0.0],
            [b * math.cos(ga), b * math.sin(ga), 0.0],
            [cx, cy, math.sqrt(cz2)],
        ]
    )


def reflectors_from_cell(
    a: float,
    b: float | None = None,
    c: float | None = None,
    alpha: float = 90.0,
    beta: float = 90.0,
    gamma: float = 90.0,
    basis=((0.0, 0.0, 0.0),),
    kv: float = 20.0,
    max_hkl: int = 3,
    min_d: float = 0.8,
    s0: float = 0.6,
    min_rel_intensity: float = 1e-4,
    hkl_filter=None,
) -> Reflectors:
    """Reflector table for an arbitrary cell with structure-factor
    extinctions — the general engine behind `cubic_reflectors` /
    `hexagonal_reflectors`.

    Plane normals are the Cartesian reciprocal-lattice vectors (so non-cubic
    normals are NOT parallel to the direct [hkl] — the metric is handled
    exactly), d-spacings come from ``1/|g|``, and each reflector is weighted
    by ``|F_hkl|² · exp(-(s/s0)²)`` with the geometric structure factor
    ``F = Σ_j exp(2πi hkl·r_j)`` over the fractional ``basis`` positions
    (equal scattering power per site — single-species kinematical
    approximation; Friedel pairs are equal, so one hemisphere representative
    suffices). Reflections with relative ``|F|²`` below
    ``min_rel_intensity`` are extinct.

    Args:
        a / b / c: cell lengths, Angstrom (b, c default to a).
        alpha / beta / gamma: cell angles, degrees.
        basis: fractional atomic positions.
        hkl_filter: optional ``(h, k, l) -> bool mask`` restricting the
            swept index box — used to keep the table closed under the point
            group when the cubic box is not (hexagonal: ``|h+k|`` can
            exceed ``max_hkl`` under index permutations).
        kv / max_hkl / min_d / s0: as in `cubic_reflectors`.
    """
    b = a if b is None else b
    c = a if c is None else c
    lam = electron_wavelength(kv)
    direct = _direct_basis(a, b, c, alpha, beta, gamma)
    recip = np.linalg.inv(direct).T  # rows: b1, b2, b3 (Cartesian, 1/A)

    rng_idx = np.arange(-max_hkl, max_hkl + 1)
    h, k, l = np.meshgrid(rng_idx, rng_idx, rng_idx, indexing="ij")
    hkl = np.stack([h.ravel(), k.ravel(), l.ravel()], axis=1)
    hkl = hkl[np.any(hkl != 0, axis=1)]
    if hkl_filter is not None:
        hkl = hkl[hkl_filter(hkl[:, 0], hkl[:, 1], hkl[:, 2])]
    # One hemisphere representative per Friedel pair.
    keep = (
        (hkl[:, 0] > 0)
        | ((hkl[:, 0] == 0) & (hkl[:, 1] > 0))
        | ((hkl[:, 0] == 0) & (hkl[:, 1] == 0) & (hkl[:, 2] > 0))
    )
    hkl = hkl[keep]

    g = hkl @ recip  # (N, 3) Cartesian reciprocal vectors
    gnorm = np.linalg.norm(g, axis=1)
    d = 1.0 / gnorm
    ok = d >= min_d
    hkl, g, gnorm, d = hkl[ok], g[ok], gnorm[ok], d[ok]

    pos = np.asarray(basis, np.float64)
    phase = 2.0 * np.pi * (hkl @ pos.T)  # (N, M)
    f2 = np.cos(phase).sum(axis=1) ** 2 + np.sin(phase).sum(axis=1) ** 2
    # Normalize by the ABSOLUTE maximum |F|^2 = M^2 (all atoms in phase),
    # not by the surviving set's max: relative normalization would rescale
    # an all-extinct selection's numerical noise to 1.0 and let forbidden
    # reflections through (caught when min_d left only the {100} family).
    f2 = f2 / float(len(pos)) ** 2
    allowed = f2 > min_rel_intensity
    hkl, g, gnorm, d, f2 = (
        hkl[allowed], g[allowed], gnorm[allowed], d[allowed], f2[allowed]
    )
    if len(hkl) == 0:
        raise ValueError(
            f"no reflectors survive min_d={min_d} at max_hkl={max_hkl} for "
            "this cell/basis — lower min_d or raise max_hkl"
        )
    sin_theta = lam / (2.0 * d)
    if np.any(sin_theta >= 1.0):
        raise ValueError("Bragg condition unsatisfiable: raise min_d or kv")
    s = 1.0 / (2.0 * d)
    intensity = f2 * np.exp(-((s / s0) ** 2))
    intensity = intensity / intensity.max()
    return Reflectors(
        normals=(g / gnorm[:, None]).astype(np.float32),
        sin_theta=sin_theta.astype(np.float32),
        intensity=intensity.astype(np.float32),
    )


def hexagonal_reflectors(
    a: float = 2.95,
    c: float = 4.68,
    kv: float = 20.0,
    max_hkl: int = 3,
    min_d: float = 0.8,
    s0: float = 0.6,
) -> Reflectors:
    """hcp reflector table (default: alpha-titanium). The swept index box is
    restricted to ``|h + k| <= max_hkl`` so the table stays exactly closed
    under the 622 point group (index permutations map (h, k) → (k, -h-k)).
    Pairs with the "622" symmetry group in multi-phase dictionaries."""
    return reflectors_from_cell(
        a, a, c, 90.0, 90.0, 120.0,
        basis=((0.0, 0.0, 0.0), (1.0 / 3.0, 2.0 / 3.0, 0.5)),
        kv=kv, max_hkl=max_hkl, min_d=min_d, s0=s0,
        hkl_filter=lambda h, k, l: np.abs(h + k) <= max_hkl,
    )


def cubic_reflectors(
    structure: str = "fcc",
    a: float = 3.52,
    kv: float = 20.0,
    max_hkl: int = 3,
    min_d: float = 0.8,
    s0: float = 0.6,
) -> Reflectors:
    """Reflector table for a cubic structure.

    Args:
        structure: "fcc" | "bcc" | "sc" lattice centering.
        a: lattice parameter, Angstrom (default: nickel).
        kv: accelerating voltage, kilovolts.
        max_hkl: largest Miller index scanned.
        min_d: drop reflectors with d-spacing below this (Angstrom) —
            high-order bands too faint/thin to matter.
        s0: kinematical falloff scale in 1/Angstrom (see module docstring).

    Returns:
        `Reflectors` with one hemisphere representative per band, every
        point-group image of each allowed family included.

    One engine, two formulations: the centering's conventional atomic basis
    drives `reflectors_from_cell`, whose structure factor reproduces the
    classical extinction rules exactly (all-even/all-odd for fcc, h+k+l
    even for bcc) — the rule formulation lives on as the independent test
    oracle (tests/sim/test_kinematical.py) rather than as a second
    production code path.
    """
    if structure not in _BASES:
        raise ValueError(
            f"unknown structure {structure!r}; choose from {sorted(_BASES)}"
        )
    try:
        return reflectors_from_cell(
            a, kv=kv, max_hkl=max_hkl, min_d=min_d, s0=s0,
            basis=_BASES[structure],
        )
    except ValueError as e:
        if "no reflectors survive" in str(e):
            raise ValueError(
                f"no {structure} reflectors survive min_d={min_d} at "
                f"max_hkl={max_hkl} — lower min_d or raise max_hkl"
            ) from None
        raise


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v (K, 3)`` by quaternions ``q (B, 4)`` (scalar-first,
    crystal→detector): returns ``(B, K, 3)``."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ).reshape(-1, 3, 3)
    # A 3-term sum per entry, elementwise: exact f32, no product to scope.
    return (r[:, None, :, :] * v[None, :, None, :]).sum(-1)


def band_intensity(quats, dirs, normals, sin_theta, intensity, edge_frac: float):
    """``(B, P)`` summed band profiles of ``(B, 4)`` unit quaternions, before
    any normalization; differentiable (`sim.refine` takes its gradient).
    Call inside `device.full_f32_matmul`."""
    n_det = _quat_rotate(quats, normals)  # (B, K, 3)
    # Every pixel direction against every rotated plane normal.
    sines = torch.matmul(dirs, n_det.transpose(1, 2))  # (B, P, K)
    soft = torch.clamp(sin_theta * edge_frac, min=1e-6)
    profile = torch.sigmoid((sin_theta - sines.abs()) / soft)
    return torch.matmul(profile, intensity)


def _render_chunk(quats, dirs, normals, sin_theta, intensity, edge_frac, out_uint8):
    """Render one orientation chunk: (B, 4) → (B, P), minmax-normalized per
    pattern, or ``round(x * 255)`` as uint8 (round half to even, as
    ``jnp.round``)."""
    x = band_intensity(quats, dirs, normals, sin_theta, intensity, edge_frac)
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    x = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    if out_uint8:
        x = torch.round(x * 255.0).to(torch.uint8)
    return x


def orientations_to_quats(orientations, angles_in_degrees: bool = False) -> np.ndarray:
    """``(B, 4)`` float32 unit quaternions of ``(B, 4)`` scalar-first
    quaternions or ``(B, 3)`` zxz Euler degrees, converted as the JAX
    package does: scipy's ``from_euler("zxz", degrees=True)`` of the float32
    angles, rolled to scalar-first."""
    o = np.asarray(orientations, np.float32)
    if angles_in_degrees or (o.ndim == 2 and o.shape[1] == 3):
        from scipy.spatial.transform import Rotation as R

        return np.roll(R.from_euler("zxz", o, degrees=True).as_quat(), 1, axis=1).astype(
            np.float32
        )
    if o.ndim == 2 and o.shape[1] == 4:
        return o / np.linalg.norm(o, axis=1, keepdims=True)
    raise ValueError(f"expected (B, 4) quats or (B, 3) Euler deg, got {o.shape}")


def model_tensors(geometry: DetectorGeometry, reflectors: Reflectors, device: torch.device):
    """The render's constants on ``device``: pixel directions ``(P, 3)``,
    normals ``(K, 3)``, Bragg sines and intensities ``(K,)``."""
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (
            pixel_directions(geometry).reshape(-1, 3),
            reflectors.normals,
            reflectors.sin_theta,
            reflectors.intensity,
        )
    )


def simulate_patterns(
    orientations: np.ndarray,
    geometry: DetectorGeometry | None = None,
    reflectors: Reflectors | None = None,
    edge_frac: float = 0.25,
    chunk: int = 64,
    angles_in_degrees: bool = False,
    dtype: type = np.float32,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Render kinematical Kikuchi patterns for a batch of orientations.

    Args:
        orientations: ``(B, 4)`` scalar-first quaternions (crystal→detector),
            or ``(B, 3)`` zxz Euler *degrees* (the anglefile convention).
        geometry: detector description (default `DetectorGeometry()`).
        reflectors: reflector table (default `cubic_reflectors()`: fcc Ni
            at 20 kV).
        edge_frac: band-edge softness as a fraction of the band half-width.
        chunk: orientations per render (bounds the ``(chunk, P, K)``
            profile tensor: 172 MB at 64 x 128² x 41).
        angles_in_degrees: interpret ``orientations`` as zxz Euler degrees.
        dtype: ``np.float32`` ([0, 1] minmax per pattern) or ``np.uint8``
            (``round(x * 255)``, 4x less device→host traffic).
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(B, H, W)`` host patterns. On the card at most 4 chunks are in
        flight: each is copied into pinned host memory on the stream, and
        the oldest is drained into the output once its copy is done, so the
        device never holds the stack.
    """
    if dtype not in (np.float32, np.uint8):
        raise ValueError("dtype must be np.float32 or np.uint8")
    dev = resolve_device(device)
    geometry = geometry or DetectorGeometry()
    reflectors = reflectors or cubic_reflectors()
    quats = torch.from_numpy(orientations_to_quats(orientations, angles_in_degrees)).to(dev)
    consts = model_tensors(geometry, reflectors, dev)
    h, w = geometry.shape
    b = len(quats)
    out = np.empty((b, h * w), dtype)
    window = 4
    pending: collections.deque = collections.deque()

    def drain_one():
        start, host, done = pending.popleft()
        if done is not None:
            done.synchronize()
        out[start : start + len(host)] = host.numpy()

    with torch.no_grad(), full_f32_matmul():
        for start in range(0, b, chunk):
            x = _render_chunk(quats[start : start + chunk], *consts, edge_frac, dtype == np.uint8)
            done = None
            if dev.type == "cuda":
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                x = host
            pending.append((start, x, done))
            if len(pending) > window:
                drain_one()
        while pending:
            drain_one()
    return out.reshape(b, h, w)
