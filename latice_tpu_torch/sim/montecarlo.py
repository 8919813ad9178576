"""Monte-Carlo backscatter simulation: energy and depth weighting for
masters, on the card.

The port of ``latice_tpu.sim.montecarlo``. EMsoft's dictionary pipeline
runs two physics stages: a Monte Carlo of electron trajectories gives the
joint (exit-energy, generation-depth) distribution of backscattered
electrons, and the master stage folds it into energy-binned Bloch-wave
masters. `sim.dynamical`'s exponential depth profile is the simplification
of the first stage; this module removes it.

Physics model (the classic single-scattering continuous-slowing-down Monte
Carlo, Joy's "Monte Carlo Modeling for Electron Microscopy"):

* **Elastic scattering: screened Rutherford.** ``σ_el = 5.21e-21 · Z²/E² ·
  4π / (α (1 + α)) · ((E + 511)/(E + 1022))²`` cm² (E in keV), screening
  ``α = 3.4e-3 · Z^0.67 / E``; polar angles ``cos θ = 1 − 2αR/(1 + α −
  R)``, uniform azimuth, exponential step lengths with mean free path
  ``λ = A / (N_A ρ σ_el)``.
* **Energy loss: Joy–Luo modified Bethe**, ``dE/ds = −78500 · ρZ/(A·E) ·
  ln(1.166 (E + 0.85 J)/J)`` keV/cm with ``J = (9.76 Z + 58.5 Z^−0.19) ·
  1e-3`` keV.
* **Compound targets** reduce to an effective single element
  (`effective_medium`).
* **Geometry.** The sample fills z > 0; the beam enters at the origin
  tilted ``tilt_deg`` from the normal. A walker whose step crosses z = 0
  exits and is backscattered if its energy is above ``e_min_kev``; its
  exit energy and the largest depth it reached are recorded.

Device design: `_walk_chunk` advances a chunk of walkers for a fixed
number of masked steps over tensors on the device (about 110 elementwise
launches a step on an H100, paced by the host); exited and stopped walkers freeze in
place, so no step depends on the data. The draws come from an explicit
``torch.Generator`` on the device, seeded per chunk by the JAX package's
derivation (`_sub_seed`): results are deterministic for a fixed seed,
chunk and electron count, but they are not ``jax.random``'s draws, so the
port is held to the JAX package by statistics. Histogramming is host
numpy over the final states, as in the JAX package.
`mc_weighted_master_pattern` solves one Bloch master per kept exit-energy
bin with the bin's measured depth distribution as the absorption
quadrature, summed in float64 by electron weight.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from latice_tpu_torch.parallel.mesh import chunk_device
from latice_tpu_torch.sim.dynamical import (
    CrystalStructure,
    channeling_intensities,
    dynamical_beams,
    lambert_master_directions,
)

__all__ = [
    "ELEMENT_A",
    "MonteCarloBSE",
    "effective_medium",
    "mc_weighted_master_pattern",
    "simulate_bse_monte_carlo",
]

#: Standard atomic weights (g/mol) for the `ELEMENT_Z` element set.
ELEMENT_A = {
    "c": 12.011, "n": 14.007, "o": 15.999, "mg": 24.305, "al": 26.982,
    "si": 28.085, "p": 30.974, "s": 32.06, "ti": 47.867, "v": 50.942,
    "cr": 51.996, "mn": 54.938, "fe": 55.845, "co": 58.933, "ni": 58.693,
    "cu": 63.546, "zn": 65.38, "ga": 69.723, "ge": 72.63, "as": 74.922,
    "se": 78.971, "zr": 91.224, "nb": 92.906, "mo": 95.95, "ag": 107.868,
    "cd": 112.414, "in": 114.818, "sn": 118.71, "sb": 121.76,
    "te": 127.6, "ta": 180.948, "w": 183.84, "pt": 195.084,
    "au": 196.967, "pb": 207.2,
}

_AVOGADRO = 6.02214076e23


def effective_medium(
    structure: CrystalStructure,
) -> tuple[float, float, float]:
    """``(Z_eff, A_eff, density g/cm³)`` of a crystal structure.

    Z and A are atomic-abundance means (the single-element reduction the
    MC model uses); density comes from the unit cell: ρ = ΣA / (N_A·V).
    """
    zs, as_ = [], []
    for site in structure.sites:
        el = site.element
        z = site.z
        if isinstance(el, str):
            key = el.lower()
            if key not in ELEMENT_A:
                raise ValueError(
                    f"no atomic weight for element {el!r}; pass z/a/"
                    "density_g_cm3 to simulate_bse_monte_carlo directly"
                )
            a = ELEMENT_A[key]
        else:
            # Integer-Z site: approximate A ≈ 2Z + Z²/157 (light-element
            # fit); explicit overrides are the precise path.
            a = 2.0 * z + z * z / 157.0
        zs.append(float(z))
        as_.append(float(a))
    volume_cm3 = structure.volume * 1e-24  # Å³ → cm³
    density = sum(as_) / (_AVOGADRO * volume_cm3)
    return float(np.mean(zs)), float(np.mean(as_)), density


def _mean_ionization_kev(z: float) -> float:
    return (9.76 * z + 58.5 * z ** -0.19) * 1e-3


@dataclasses.dataclass(frozen=True)
class MonteCarloBSE:
    """Backscatter statistics from `simulate_bse_monte_carlo`.

    Attributes:
        energy_edges_kev: ``(nE + 1,)`` exit-energy bin edges.
        energy_weights: ``(nE,)`` fraction of BSE per energy bin
            (sums to 1 over bins; empty bins are 0).
        depth_centers_nm: ``(nZ,)`` generation-depth bin centers.
        depth_weights: ``(nE, nZ)`` depth distribution per energy bin,
            each row summing to 1 (uniform rows for empty bins).
        bse_yield: backscatter coefficient η (BSE / incident).
        exit_energy_kev / max_depth_nm: per-BSE raw samples (diagnostics
            and re-binning).
        e0_kev / tilt_deg: simulation conditions.
    """

    energy_edges_kev: np.ndarray
    energy_weights: np.ndarray
    depth_centers_nm: np.ndarray
    depth_weights: np.ndarray
    bse_yield: float
    exit_energy_kev: np.ndarray
    max_depth_nm: np.ndarray
    e0_kev: float
    tilt_deg: float

    @property
    def energy_centers_kev(self) -> np.ndarray:
        return 0.5 * (self.energy_edges_kev[1:] + self.energy_edges_kev[:-1])


def _sub_seed(seed: int, idx: int) -> int:
    """Per-chunk seed: the JAX package's derivation."""
    return int(np.uint32((seed * 1_000_003 + idx) & 0xFFFFFFFF))


def _walk_chunk(seed, *, n, n_steps, z, a, density, e_min_kev, e0_kev, tilt_rad, device):
    """Trace ``n`` walkers for ``n_steps`` scattering events on ``device``;
    returns ``(exit_energy_kev, max_depth_nm)``, each ``(n,)`` float32 on
    the device (exit energy -1 for walkers that never left).

    State per walker: depth z (nm), direction (three components), energy
    (keV), alive flag, exit energy, max depth. Exited and stopped walkers
    freeze (masked updates)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    j_kev = _mean_ionization_kev(z)
    n_dens = _AVOGADRO * density / a  # atoms / cm³
    screen = 3.4e-3 * z**0.67
    loss = 78500.0 * density * z / a
    pos_z = torch.zeros(n, **f32)
    dx = torch.full((n,), math.sin(tilt_rad), **f32)
    dy = torch.zeros(n, **f32)
    dz = torch.full((n,), math.cos(tilt_rad), **f32)
    e = torch.full((n,), float(e0_kev), **f32)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    exit_e = torch.full((n,), -1.0, **f32)
    max_z = torch.zeros(n, **f32)
    for _ in range(n_steps):
        u_step, r, u_phi = torch.rand((3, n), generator=gen, **f32)
        alpha = screen / e
        rel = ((e + 511.0) / (e + 1022.0)) ** 2
        sigma_el = 5.21e-21 * (z / e) ** 2 * (4.0 * math.pi) / (alpha * (1.0 + alpha)) * rel
        lam_nm = 1e7 / (n_dens * sigma_el)  # cm → nm
        s_nm = -lam_nm * torch.log(torch.clamp(u_step, min=1e-12))
        # Joy–Luo Bethe loss over the step (keV); a floor keeps the log
        # finite for frozen walkers.
        de_ds = loss / e * torch.log(1.166 * (e + 0.85 * j_kev) / j_kev)  # keV/cm
        e_new = torch.clamp(e - de_ds * s_nm * 1e-7, min=0.05)
        # Screened-Rutherford polar angle, uniform azimuth.
        cos_t = 1.0 - 2.0 * alpha * r / (1.0 + alpha - r)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
        phi = u_phi * (2.0 * math.pi)
        # Rotate the deflection into each walker's frame.
        perp = torch.sqrt(torch.clamp(1.0 - dz**2, min=1e-12))
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        nx = sin_t * (cphi * dx * dz - sphi * dy) / perp + dx * cos_t
        ny = sin_t * (cphi * dy * dz + sphi * dx) / perp + dy * cos_t
        nz = -sin_t * cphi * perp + dz * cos_t
        # Along ±z the frame degenerates (perp → 0): any azimuth frame
        # works there, so the lab frame is used.
        pole = perp < 1e-4
        nx = torch.where(pole, sin_t * cphi, nx)
        ny = torch.where(pole, sin_t * sphi, ny)
        nz = torch.where(pole, cos_t * torch.sign(dz), nz)
        inv = torch.rsqrt(nx * nx + ny * ny + nz * nz)

        z_new = pos_z + dz * s_nm  # move along the OLD direction
        exited = alive & (z_new < 0.0)
        stopped = alive & (e_new < e_min_kev) & ~exited
        live_next = alive & ~exited & ~stopped
        pos_z = torch.where(alive, torch.clamp(z_new, min=0.0), pos_z)
        max_z = torch.maximum(max_z, torch.where(alive, z_new, max_z))
        exit_e = torch.where(exited, e, exit_e)  # energy at the surface crossing
        e = torch.where(live_next, e_new, e)
        dx = torch.where(live_next, nx * inv, dx)
        dy = torch.where(live_next, ny * inv, dy)
        dz = torch.where(live_next, nz * inv, dz)
        alive = live_next
    return exit_e, max_z


def simulate_bse_monte_carlo(
    structure: CrystalStructure | None = None,
    kv: float = 20.0,
    tilt_deg: float = 70.0,
    n_electrons: int = 200_000,
    n_steps: int = 400,
    e_min_kev: float | None = None,
    energy_bins: int = 10,
    depth_bins: int = 40,
    max_depth_nm: float | None = None,
    seed: int = 0,
    chunk: int = 262_144,
    z: float | None = None,
    a: float | None = None,
    density_g_cm3: float | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> MonteCarloBSE:
    """Simulate backscattered-electron (energy, depth) statistics.

    Args:
        structure: crystal (→ effective Z/A/density); or pass ``z``/``a``/
            ``density_g_cm3`` explicitly (all three) and omit it.
        kv: beam energy E₀, keV.
        tilt_deg: sample tilt from normal incidence (EBSD: 70°).
        n_electrons: incident electrons traced.
        n_steps: scattering events per electron.
        e_min_kev: BSE counting threshold (default E₀/10).
        energy_bins / depth_bins: histogram resolution of the output.
        max_depth_nm: depth histogram extent (default: the 99th percentile
            of observed generation depths, rounded up).
        seed: RNG seed (deterministic for a fixed seed, chunk and count).
        chunk: walkers per device pass (at most ``n_electrons``).
        z / a / density_g_cm3: explicit effective medium override.
        mesh: optional `parallel.Mesh`: chunk ``i`` walks on device
            ``i % mesh.size`` from the same ``_sub_seed(seed, i)`` as on one
            device, so the result is bit-equal to one device's on devices
            of one type.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.
    """
    if structure is not None:
        z_eff, a_eff, rho = effective_medium(structure)
    else:
        if z is None or a is None or density_g_cm3 is None:
            raise ValueError("pass a structure, or all three of z/a/density_g_cm3")
        z_eff, a_eff, rho = float(z), float(a), float(density_g_cm3)
    if z is not None:
        z_eff = float(z)
    if a is not None:
        a_eff = float(a)
    if density_g_cm3 is not None:
        rho = float(density_g_cm3)
    if not 0.0 <= tilt_deg < 90.0:
        raise ValueError(f"tilt_deg must be in [0, 90), got {tilt_deg}")
    dev = chunk_device(mesh, device)
    walkers = [dev] if mesh is None else list(mesh.devices)
    e_min = float(e_min_kev if e_min_kev is not None else kv / 10.0)
    t = math.radians(tilt_deg)
    chunk = max(1, min(int(chunk), int(n_electrons)))

    exits, depths = [], []
    done = 0
    chunk_index = 0
    while done < n_electrons:
        m = min(chunk, n_electrons - done)
        ee, mz = _walk_chunk(
            _sub_seed(seed, chunk_index), n=chunk, n_steps=n_steps, z=z_eff, a=a_eff,
            density=rho, e_min_kev=e_min, e0_kev=float(kv), tilt_rad=t,
            device=walkers[chunk_index % len(walkers)],
        )
        exits.append(ee[:m].to(dev))
        depths.append(mz[:m].to(dev))
        done += m
        chunk_index += 1
    exit_e = torch.cat(exits).cpu().numpy() if exits else np.empty(0, np.float32)
    max_z = torch.cat(depths).cpu().numpy() if depths else np.empty(0, np.float32)

    bse = exit_e >= e_min
    exit_e_b = exit_e[bse]
    max_z_b = max_z[bse]
    bse_yield = float(bse.mean())
    if len(exit_e_b) == 0:
        raise ValueError(
            "no backscattered electrons above e_min_kev — raise "
            "n_electrons/n_steps or lower e_min_kev"
        )

    e_edges = np.linspace(e_min, float(kv), energy_bins + 1)
    if max_depth_nm is None:
        max_depth_nm = float(np.ceil(np.percentile(max_z_b, 99.0) / 10.0) * 10.0) or 10.0
    z_edges = np.linspace(0.0, max_depth_nm, depth_bins + 1)
    z_centers = 0.5 * (z_edges[1:] + z_edges[:-1])

    e_idx = np.clip(np.digitize(exit_e_b, e_edges) - 1, 0, energy_bins - 1)
    e_weights = np.bincount(e_idx, minlength=energy_bins).astype(np.float64)
    e_weights /= e_weights.sum()
    depth_w = np.full((energy_bins, depth_bins), 1.0 / depth_bins)
    for b in range(energy_bins):
        sel = max_z_b[e_idx == b]
        if len(sel):
            h, _ = np.histogram(np.clip(sel, 0, max_depth_nm), bins=z_edges)
            tot = h.sum()
            if tot:
                depth_w[b] = h / tot
    return MonteCarloBSE(
        energy_edges_kev=e_edges,
        energy_weights=e_weights,
        depth_centers_nm=z_centers,
        depth_weights=depth_w,
        bse_yield=bse_yield,
        exit_energy_kev=exit_e_b,
        max_depth_nm=max_z_b,
        e0_kev=float(kv),
        tilt_deg=float(tilt_deg),
    )


def fold_energy_bins(weights: np.ndarray, min_bin_weight: float) -> tuple[list[int], np.ndarray]:
    """The kept energy bins and their weights: bins lighter than
    ``min_bin_weight`` fold into their nearest kept neighbour (the heaviest
    bin is kept when none reaches it)."""
    weights = np.asarray(weights, np.float64).copy()
    kept = [b for b in range(len(weights)) if weights[b] >= min_bin_weight]
    if not kept:
        kept = [int(np.argmax(weights))]
    for b in range(len(weights)):
        if b not in kept and weights[b] > 0:
            near = kept[int(np.argmin([abs(b - kb) for kb in kept]))]
            weights[near] += weights[b]
            weights[b] = 0.0
    return kept, weights


def mc_weighted_master_pattern(
    structure: CrystalStructure,
    mc: MonteCarloBSE,
    size: int = 201,
    n_beams: int = 64,
    absorption_ratio: float = 0.1,
    max_hkl: int = 5,
    min_d: float = 0.4,
    chunk: int = 2048,
    min_bin_weight: float = 0.02,
    normalize: bool = True,
    mesh=None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Energy- and depth-weighted dynamical master pattern.

    One Bloch-wave master per Monte-Carlo exit-energy bin, the N-beam
    problem solved again at that energy with the bin's MEASURED depth
    distribution as the absorption quadrature, summed in float64 with the
    bin's electron weight. Bins lighter than ``min_bin_weight`` fold into
    their nearest kept neighbour (`fold_energy_bins`). Output matches
    `dynamical_master_pattern`'s equal-area convention. ``mesh`` shards
    each bin's pixel chunks (`channeling_intensities`).
    """
    if size < 3:
        raise ValueError(f"master size must be >= 3, got {size}")
    dev = chunk_device(mesh, device, chunk)
    d = lambert_master_directions(size)
    centers = mc.energy_centers_kev
    kept, weights = fold_energy_bins(mc.energy_weights, min_bin_weight)
    img = np.zeros(d.shape[:-1], np.float64)
    for b in kept:
        beams = dynamical_beams(
            structure, kv=float(centers[b]), n_beams=n_beams, max_hkl=max_hkl, min_d=min_d
        )
        part = channeling_intensities(
            d, beams, absorption_ratio=absorption_ratio, chunk=chunk,
            depth_centers_nm=mc.depth_centers_nm, depth_weights=mc.depth_weights[b],
            mesh=mesh, device=dev,
        )
        img += weights[b] * part.astype(np.float64)
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-12)
    return img.astype(np.float32)
