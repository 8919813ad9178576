"""Dynamical (Bloch-wave) master patterns on the card.

The port of ``latice_tpu.sim.dynamical``. The kinematical renderer
(`sim.kinematical`) gets band geometry exactly but fakes intensities; the
band profiles of real patterns (excess bands, dark edge lines, profile
asymmetry) are many-beam dynamical effects. This module computes a master
pattern from first principles, so that ``cli.index sample`` → ``master`` →
``simulate --master`` → ``build`` → ``query`` needs no external simulation
package.

Physics model (every approximation named; the JAX module's docstring has
the derivation):

* **Bloch-wave channeling with reciprocity.** For each master pixel ``d``
  the N-beam Bloch eigenproblem ``[U_{g-h} / (2k) + δ_gh s_g(d)] C_j =
  γ_j C_j`` is solved, with ``s_g = d·g − |g|²/(2k)``. The intensity is
  the depth-integrated, state-resolved channeling yield ``I(d) = Σ_j
  |C_{0j}|² σ_j / (1 + 2π q_j z₀)``, where ``σ_j = c_jᵀ B c_j`` is state
  j's overlap with the Z²-weighted site density and ``q_j`` its
  absorption; a measured depth histogram (`sim.montecarlo`) replaces the
  exponential profile with a quadrature.
* **Scattering factors: Wentzel screened Coulomb** (`wentzel_form_factor`).
* **Any crystal.** Centrosymmetric structures are re-origined onto the
  inversion center and solve a batched real symmetric ``eigh``;
  non-centrosymmetric ones (zincblende, wurtzite) have a complex-Hermitian
  Bloch matrix, solved through the real embedding ``H = A + iB →
  [[A, −B], [B, A]]`` (a 2N×2N real symmetric ``eigh``; summing all 2N
  embedded states and halving equals the complex sum exactly).

Host and device split as in the JAX package: everything independent of the
direction (beam selection, the coupling and backscatter matrices) is host
float64 numpy, copied from the JAX module so that it equals it bitwise.
Per chunk of directions, on the device in float32: the diagonal build, a
batched ``torch.linalg.eigh``, the contraction ``bgj,gh,bhj->bj`` as one
batched product and a reduction, and the closed-form depth integral or the
measured-depth quadrature. The products run at full float32
(`device.full_f32_matmul`): under TF32 the excitation weights move past
the solver's own roundoff. ``eigh`` checks its convergence on the host, so
each chunk waits for the device once; the chunks' results stay on the
device and come back in one copy. Entry points run on ``cuda`` unless
``device="cpu"`` is passed. With ``mesh=`` each direction chunk shards
over the mesh's devices (each direction's eigenproblem is independent), the
beam tables copied to each.

Eigenvectors are unique only up to sign, and up to a rotation inside a
degenerate eigenspace (zone axes and mirror lines of the master). Every
output here is invariant under both, so the card's solver (cuSOLVER) and
the CPU's (LAPACK) agree on intensities to float32 roundoff of the
eigendecomposition, while their vectors may differ.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from latice_tpu_torch.device import full_f32_matmul
from latice_tpu_torch.parallel.mesh import chunk_device, map_blocks, replicate
from latice_tpu_torch.sim.kinematical import _direct_basis, electron_wavelength
from latice_tpu_torch.sim.master import lambert_to_directions

__all__ = [
    "AtomSite",
    "CrystalStructure",
    "DynamicalBeams",
    "ELEMENT_Z",
    "channeling_intensities",
    "cubic_structure",
    "dynamical_beams",
    "dynamical_master_pattern",
    "fourier_potential",
    "fourier_potential_complex",
    "hexagonal_structure",
    "wentzel_form_factor",
    "wurtzite_structure",
    "zincblende_structure",
]

_BOHR_A = 0.529177  # Bohr radius, Angstrom

# Atomic numbers for the elements a metallurgical EBSD lab actually meets.
# Anything else: pass the Z directly as AtomSite.element (int accepted).
ELEMENT_Z = {
    "c": 6, "n": 7, "o": 8, "mg": 12, "al": 13, "si": 14, "p": 15,
    "s": 16, "ti": 22, "v": 23, "cr": 24, "mn": 25, "fe": 26, "co": 27,
    "ni": 28, "cu": 29, "zn": 30, "ga": 31, "ge": 32, "as": 33, "se": 34,
    "zr": 40, "nb": 41, "mo": 42, "ag": 47, "cd": 48, "in": 49, "sn": 50,
    "sb": 51, "te": 52, "ta": 73, "w": 74, "pt": 78, "au": 79, "pb": 82,
}


def wentzel_form_factor(z: int) -> Callable[[np.ndarray], np.ndarray]:
    """Electron scattering factor f_e(s) [Å] for atomic number ``z`` under
    Wentzel (exponentially screened Coulomb) charge with the Thomas-Fermi
    radius: ``f(s) = Z / (8π² a₀ (s² + s_s²))``, ``s = sinθ/λ`` in 1/Å.
    Mott-Bethe-consistent with the same model's X-ray factor (the test
    suite pins both the s→∞ Rutherford limit and f(0) = 2 Z R²/a₀)."""
    if z < 1:
        raise ValueError(f"atomic number must be positive, got {z}")
    radius = 0.885 * _BOHR_A * float(z) ** (-1.0 / 3.0)
    s_screen2 = (1.0 / (4.0 * math.pi * radius)) ** 2
    pref = float(z) / (8.0 * math.pi**2 * _BOHR_A)

    def f(s: np.ndarray) -> np.ndarray:
        return pref / (np.asarray(s, np.float64) ** 2 + s_screen2)

    return f


@dataclasses.dataclass(frozen=True)
class AtomSite:
    """One atom of the basis.

    Attributes:
        element: symbol from `ELEMENT_Z` (case-insensitive) or an atomic
            number.
        frac: fractional coordinates in the cell.
        debye_waller: isotropic B factor, Å² (thermal smearing of both the
            potential and the backscatter site density).
        form_factor: optional exact ``f_e(s[1/Å]) -> Å`` override (e.g. a
            Doyle-Turner fit); default is the Wentzel model for ``Z``.
    """

    element: str | int
    frac: tuple[float, float, float]
    debye_waller: float = 0.35
    form_factor: Callable[[np.ndarray], np.ndarray] | None = None

    @property
    def z(self) -> int:
        if isinstance(self.element, int):
            return self.element
        key = self.element.lower()
        if key not in ELEMENT_Z:
            raise ValueError(
                f"unknown element {self.element!r}: pass one of "
                f"{sorted(ELEMENT_Z)} or an atomic number"
            )
        return ELEMENT_Z[key]

    def factor(self, s: np.ndarray) -> np.ndarray:
        f = self.form_factor or wentzel_form_factor(self.z)
        return np.asarray(f(np.asarray(s, np.float64)), np.float64)


@dataclasses.dataclass(frozen=True)
class CrystalStructure:
    """Cell + decorated basis for dynamical simulation.

    Use `cubic_structure` / `hexagonal_structure` for the common cases;
    arbitrary (centrosymmetric) cells go through the constructor directly.
    """

    a: float
    b: float
    c: float
    alpha: float = 90.0
    beta: float = 90.0
    gamma: float = 90.0
    sites: tuple[AtomSite, ...] = ()

    def __post_init__(self):
        if not self.sites:
            raise ValueError("structure needs at least one atom site")

    @functools.cached_property
    def direct_basis(self) -> np.ndarray:
        """(3, 3) Cartesian direct-lattice rows, Å."""
        return _direct_basis(
            self.a, self.b, self.c, self.alpha, self.beta, self.gamma
        )

    @functools.cached_property
    def reciprocal_basis(self) -> np.ndarray:
        """(3, 3) Cartesian reciprocal rows b1..b3, 1/Å (no 2π)."""
        return np.linalg.inv(self.direct_basis).T

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.direct_basis)))

    def centered_sites(self) -> "CrystalStructure":
        """Re-origin onto an inversion center so every U_g is real.

        Tries every midpoint of a same-species site pair (and each site
        itself) as the candidate center; raises for genuinely
        non-centrosymmetric bases (see module docstring for why those are
        out of scope).
        """
        frac = np.array([s.frac for s in self.sites], np.float64) % 1.0
        species = [
            (s.z, round(s.debye_waller, 6), s.form_factor) for s in self.sites
        ]
        candidates = []
        for i in range(len(frac)):
            for j in range(len(frac)):
                if species[i] == species[j]:
                    candidates.append((frac[i] + frac[j]) / 2.0)
                    # Lattice-translated images of r_j give distinct
                    # midpoints mod 1 — the hcp center lives on one.
                    candidates.append((frac[i] + frac[j] + 1.0) / 2.0)
        for t in candidates:
            shifted = (frac - t) % 1.0
            inverted = (-shifted) % 1.0
            used = [False] * len(frac)
            ok = True
            for i in range(len(frac)):
                hit = False
                for j in range(len(frac)):
                    if used[j] or species[i] != species[j]:
                        continue
                    diff = np.abs(inverted[i] - shifted[j])
                    if np.all(np.minimum(diff, 1.0 - diff) < 1e-6):
                        used[j] = hit = True
                        break
                if not hit:
                    ok = False
                    break
            if ok:
                new_sites = tuple(
                    dataclasses.replace(s, frac=tuple(sf))
                    for s, sf in zip(self.sites, shifted)
                )
                return dataclasses.replace(self, sites=new_sites)
        raise NotImplementedError(
            "no inversion center found: this structure has no "
            "centrosymmetric setting (callers fall back to the "
            "complex-Hermitian Bloch path — see reflector_beams)"
        )


def cubic_structure(
    centering: str = "fcc",
    element: str | int = "ni",
    a: float = 3.52,
    debye_waller: float = 0.35,
) -> CrystalStructure:
    """fcc / bcc / sc single-species structure (default: nickel)."""
    bases = {
        "fcc": ((0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)),
        "bcc": ((0, 0, 0), (0.5, 0.5, 0.5)),
        "sc": ((0, 0, 0),),
    }
    if centering not in bases:
        raise ValueError(
            f"unknown centering {centering!r}; choose from {sorted(bases)}"
        )
    sites = tuple(
        AtomSite(element, tuple(float(x) for x in f), debye_waller)
        for f in bases[centering]
    )
    return CrystalStructure(a, a, a, sites=sites)


def hexagonal_structure(
    element: str | int = "ti",
    a: float = 2.95,
    c: float = 4.68,
    debye_waller: float = 0.35,
) -> CrystalStructure:
    """hcp structure (default: alpha-titanium). Centrosymmetric: the
    inversion center sits between the two basis atoms and
    `centered_sites` finds it automatically."""
    sites = (
        AtomSite(element, (0.0, 0.0, 0.0), debye_waller),
        AtomSite(element, (1.0 / 3.0, 2.0 / 3.0, 0.5), debye_waller),
    )
    return CrystalStructure(a, a, c, gamma=120.0, sites=sites)


def zincblende_structure(
    cation: str | int = "ga",
    anion: str | int = "as",
    a: float = 5.653,
    debye_waller: float = 0.5,
) -> CrystalStructure:
    """Zincblende (F-43m) two-species structure — non-centrosymmetric
    (default: GaAs). Cation on the fcc lattice, anion displaced by
    (¼, ¼, ¼); no inversion center exists, so `dynamical_beams` takes the
    complex-Hermitian path automatically."""
    fcc = ((0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0))
    sites = tuple(
        AtomSite(cation, tuple(float(x) for x in f), debye_waller)
        for f in fcc
    ) + tuple(
        AtomSite(
            anion,
            tuple(float(x + 0.25) % 1.0 for x in f),
            debye_waller,
        )
        for f in fcc
    )
    return CrystalStructure(a, a, a, sites=sites)


def wurtzite_structure(
    cation: str | int = "ga",
    anion: str | int = "n",
    a: float = 3.189,
    c: float = 5.185,
    u: float = 0.377,
    debye_waller: float = 0.5,
) -> CrystalStructure:
    """Wurtzite (P6₃mc) two-species structure — non-centrosymmetric and
    polar (default: GaN; ZnO is ``("zn", "o", 3.250, 5.207, 0.382)``).
    ``u`` is the internal anion displacement parameter (ideal: 3/8)."""
    sites = (
        AtomSite(cation, (0.0, 0.0, 0.0), debye_waller),
        AtomSite(cation, (1.0 / 3.0, 2.0 / 3.0, 0.5), debye_waller),
        AtomSite(anion, (0.0, 0.0, float(u)), debye_waller),
        AtomSite(anion, (1.0 / 3.0, 2.0 / 3.0, 0.5 + float(u)), debye_waller),
    )
    return CrystalStructure(a, a, c, gamma=120.0, sites=sites)


def fourier_potential_complex(
    structure: CrystalStructure, hkl: np.ndarray, kv: float
) -> np.ndarray:
    """Complex U_g in Å⁻² for integer ``hkl`` rows — the general structure
    sum, valid for any origin and any (non-)centrosymmetric basis.

    ``U_g = γ_rel/(π V_c) Σ_a f_a(s) e^{−B_a s²} e^{−2πi g·r_a}`` with
    ``s = |g|/2`` — the standard relation ``U_g = 2m|e|V_g/h²`` with
    ``V_g = h²/(2π m₀ e V_c) Σ f`` folded together (relativistic mass in
    γ_rel). The potential is real in space, so ``U_{−g} = conj(U_g)`` and
    the Bloch coupling matrix built from it is Hermitian."""
    hkl = np.atleast_2d(np.asarray(hkl, np.float64))
    g = hkl @ structure.reciprocal_basis
    s = np.linalg.norm(g, axis=-1) / 2.0
    gamma_rel = 1.0 + kv / 511.0  # kV over m0 c² (keV)
    total = np.zeros(len(hkl), np.complex128)
    for site in structure.sites:
        phase = 2.0 * np.pi * (hkl @ np.asarray(site.frac, np.float64))
        total += (
            site.factor(s)
            * np.exp(-site.debye_waller * s * s)
            * np.exp(-1j * phase)
        )
    return gamma_rel / (np.pi * structure.volume) * total


def fourier_potential(
    structure: CrystalStructure, hkl: np.ndarray, kv: float
) -> np.ndarray:
    """Real U_g in Å⁻² for integer ``hkl`` rows: the real part of
    `fourier_potential_complex` — i.e. the cosine structure sum. Exact for
    structures re-origined onto an inversion center (`centered_sites`),
    where the sine part vanishes identically."""
    return fourier_potential_complex(structure, hkl, kv).real


@dataclasses.dataclass(frozen=True)
class DynamicalBeams:
    """Direction-independent pieces of the N-beam problem (host-precomputed).

    Attributes:
        hkl: (N, 3) int beam indices, beam 0 is the transmitted ``000``.
        g: (N, 3) Cartesian reciprocal vectors, 1/Å.
        coupling: (N, N) float32 ``Re U_{g_i − g_j} / (2 k_int)`` with zero
            diagonal, 1/Å — the (real part of the) off-diagonal Bloch
            matrix. Symmetric.
        backscatter: (N, N) float32 Z²-weighted site-density moment matrix
            (real part), normalized so the diagonal is 1 (the complex
            matrix is PSD Hermitian by construction).
        k_int: interior wavevector magnitude ``sqrt(1/λ² + U_0)``, 1/Å.
        u0: mean inner potential U_0, Å⁻².
        coupling_imag: None for centrosymmetric structures (real Bloch
            matrix — the fast eigh path); otherwise the (N, N) float32
            antisymmetric imaginary part ``Im U_{g_i − g_j} / (2 k_int)``.
        backscatter_imag: None iff ``coupling_imag`` is None; otherwise
            the antisymmetric imaginary part of the backscatter moment
            matrix.
    """

    hkl: np.ndarray
    g: np.ndarray
    coupling: np.ndarray
    backscatter: np.ndarray
    k_int: float
    u0: float
    coupling_imag: np.ndarray | None = None
    backscatter_imag: np.ndarray | None = None

    @property
    def is_centrosymmetric(self) -> bool:
        return self.coupling_imag is None

    def __len__(self) -> int:
        return len(self.hkl)


def dynamical_beams(
    structure: CrystalStructure,
    kv: float = 20.0,
    n_beams: int = 64,
    max_hkl: int = 5,
    min_d: float = 0.4,
) -> DynamicalBeams:
    """Select the strongest N beams and precompute the coupling matrices.

    Selection is by |U_g| (then by |g|) over the ±max_hkl index box with
    d ≥ min_d, **never splitting a (|g|, |U_g|)-degenerate family** — a
    split family would break the master's point-group invariance (pinned
    by test). The realized beam count may therefore come in slightly under
    ``n_beams``. Beam 0 is always the transmitted beam.

    Centrosymmetric structures are re-origined onto the inversion center
    (real U_g → the fast real-symmetric eigh path). Non-centrosymmetric
    structures keep their origin and get complex-Hermitian coupling /
    backscatter matrices (``coupling_imag``/``backscatter_imag`` set) —
    `channeling_intensities` then solves via the 2N real embedding (module
    docstring).
    """
    try:
        structure = structure.centered_sites()
        centro = True
    except NotImplementedError:
        centro = False
    rng_idx = np.arange(-max_hkl, max_hkl + 1)
    h, k, l = np.meshgrid(rng_idx, rng_idx, rng_idx, indexing="ij")
    hkl = np.stack([h.ravel(), k.ravel(), l.ravel()], axis=1)
    hkl = hkl[np.any(hkl != 0, axis=1)]
    g = hkl @ structure.reciprocal_basis
    gnorm = np.linalg.norm(g, axis=1)
    ok = (1.0 / gnorm) >= min_d
    hkl, g, gnorm = hkl[ok], g[ok], gnorm[ok]
    u = fourier_potential_complex(structure, hkl, kv)
    if centro:
        u = u.real  # sine part vanishes identically after re-origin

    strong = np.abs(u) > 1e-12  # extinct reflections carry no coupling
    hkl, g, gnorm, u = hkl[strong], g[strong], gnorm[strong], u[strong]
    order = np.lexsort((gnorm, -np.abs(u)))
    hkl, g, gnorm, u = hkl[order], g[order], gnorm[order], u[order]

    # Family = run of equal (|U|, |g|) within tolerance (a union of
    # point-group orbits, so supersets stay closed). Walk families whole.
    au = np.abs(u)
    count = 1  # the transmitted beam
    take = np.zeros(len(hkl), bool)
    i = 0
    while i < len(hkl):
        j = i
        while (
            j < len(hkl)
            and np.isclose(au[j], au[i], rtol=1e-6, atol=1e-12)
            and np.isclose(gnorm[j], gnorm[i], rtol=1e-6)
        ):
            j += 1
        if count + (j - i) > n_beams:
            break
        take[i:j] = True
        count += j - i
        i = j
    if count == 1:
        raise ValueError(
            f"n_beams={n_beams} leaves no room for the weakest whole "
            "reflection family — raise n_beams"
        )
    hkl, g = hkl[take], g[take]

    hkl = np.concatenate([np.zeros((1, 3), hkl.dtype), hkl])
    g = np.concatenate([np.zeros((1, 3)), g])

    lam = electron_wavelength(kv)
    u0 = float(fourier_potential(structure, np.zeros((1, 3)), kv)[0])
    k_int = math.sqrt(1.0 / lam**2 + u0)

    dh = hkl[:, None, :] - hkl[None, :, :]
    n = len(hkl)
    u_mat = fourier_potential_complex(
        structure, dh.reshape(-1, 3), kv
    ).reshape(n, n)
    coupling = u_mat / (2.0 * k_int)  # Hermitian: U_{-g} = conj(U_g)
    np.fill_diagonal(coupling, 0.0)

    dg = dh.reshape(-1, 3) @ structure.reciprocal_basis
    s = np.linalg.norm(dg, axis=-1) / 2.0
    frac = np.array([site.frac for site in structure.sites], np.float64)
    z2 = np.array([site.z**2 for site in structure.sites], np.float64)
    bfac = np.array([site.debye_waller for site in structure.sites])
    phase = 2.0 * np.pi * (dh.reshape(-1, 3) @ frac.T)  # (N², M)
    bs = (
        (z2[None, :] * np.exp(-bfac[None, :] * (s * s)[:, None]))
        * np.exp(-1j * phase)
    ).sum(axis=1)
    backscatter = (bs / z2.sum()).reshape(n, n)

    return DynamicalBeams(
        hkl=hkl.astype(np.int32),
        g=g.astype(np.float32),
        coupling=coupling.real.astype(np.float32),
        backscatter=backscatter.real.astype(np.float32),
        k_int=k_int,
        u0=u0,
        coupling_imag=(
            None if centro else coupling.imag.astype(np.float32)
        ),
        backscatter_imag=(
            None if centro else backscatter.imag.astype(np.float32)
        ),
    )


def _excitation_errors(dirs, g, k_int):
    """``s_g = d·g − |g|²/(2k)`` for a beam incident along ``-d``
    (reciprocity): ``(B, N)``."""
    return dirs @ g.T - (torch.sum(g * g, dim=1) / (2.0 * k_int))[None, :]


def _bloch_states(dirs, g, coupling, k_int):
    """Excitation ``|C_0j|²`` and Bloch eigenvectors for the real path."""
    mats = coupling[None, :, :] + torch.diag_embed(_excitation_errors(dirs, g, k_int))
    _, vecs = torch.linalg.eigh(mats)  # (B, N, N), columns = Bloch states
    return vecs[:, 0, :] ** 2, vecs


def _bloch_states_hermitian(dirs, g, cr, ci, k_int):
    """Excitation and embedded eigenvectors for the 2N real embedding.

    Solves ``H = A + iB`` (A symmetric with the excitation-error diagonal,
    B antisymmetric) through ``M = [[A, −B], [B, A]]``, a 2N×2N real
    symmetric ``eigh``. Its eigenvectors come in partners (u; v) / (−v; u),
    both encoding the complex state c = u + iv; excitation ``|c₀|² = w₀² +
    w_N²``, overlap and absorption are invariant under the rotation inside
    such a pair, so summing all 2N states and halving is the complex sum."""
    n = g.shape[0]
    a = cr[None, :, :] + torch.diag_embed(_excitation_errors(dirs, g, k_int))
    ci_b = ci.expand(a.shape)
    mats = torch.cat([torch.cat([a, -ci_b], dim=2), torch.cat([ci_b, a], dim=2)], dim=1)
    _, vecs = torch.linalg.eigh(mats)
    return vecs[:, 0, :] ** 2 + vecs[:, n, :] ** 2, vecs


def _embed_backscatter(br, bi):
    """(2N, 2N) real embedding of the Hermitian backscatter matrix."""
    return torch.cat([torch.cat([br, -bi], dim=1), torch.cat([bi, br], dim=1)], dim=0)


def _overlaps(vecs, backscatter):
    """``σ_j = c_jᵀ B c_j`` of every state: ``einsum("bgj,gh,bhj->bj")`` as
    one batched product and a reduction over ``g``."""
    return torch.sum(vecs * (backscatter @ vecs), dim=1)


def _channel_chunk(dirs, g, coupling, backscatter, k_int, q_scale, z0):
    """Channeling yield for one direction chunk, exponential depth profile:
    ``(B, 3) → (B,)``. f32 throughout: eigenvalue spreads are ~1e-2 1/Å
    against f32's 1e-7 relative floor."""
    alpha2, vecs = _bloch_states(dirs, g, coupling, k_int)
    sigma = _overlaps(vecs, backscatter)
    depth = 1.0 / (1.0 + (2.0 * math.pi * q_scale * z0) * sigma)
    return torch.sum(alpha2 * sigma * depth, dim=1)


def _channel_chunk_hermitian(dirs, g, cr, ci, br, bi, k_int, q_scale, z0):
    """Channeling yield, complex-Hermitian Bloch matrix: ``(B, 3) → (B,)``."""
    exc, vecs = _bloch_states_hermitian(dirs, g, cr, ci, k_int)
    sigma = _overlaps(vecs, _embed_backscatter(br, bi))
    depth = 1.0 / (1.0 + (2.0 * math.pi * q_scale * z0) * sigma)
    return 0.5 * torch.sum(exc * sigma * depth, dim=1)


def _channel_chunk_quad(dirs, g, coupling, backscatter, z_ang, z_w, k_int, q_scale):
    """Channeling yield with a MEASURED depth distribution: the closed form
    ``1/(1 + 2π q_j z₀)`` becomes ``Σ_b w_b e^{−2π q_j z_b}`` over the
    histogram bins (z in Å, weights summing to 1)."""
    alpha2, vecs = _bloch_states(dirs, g, coupling, k_int)
    sigma = _overlaps(vecs, backscatter)
    rate = (2.0 * math.pi * q_scale) * sigma  # absorption, 1/Å per state
    depth = torch.exp(-rate[..., None] * z_ang) @ z_w  # (B, J, nZ) @ (nZ,)
    return torch.sum(alpha2 * sigma * depth, dim=1)


def _channel_chunk_hermitian_quad(dirs, g, cr, ci, br, bi, z_ang, z_w, k_int, q_scale):
    """Measured-depth-quadrature variant of `_channel_chunk_hermitian`."""
    exc, vecs = _bloch_states_hermitian(dirs, g, cr, ci, k_int)
    sigma = _overlaps(vecs, _embed_backscatter(br, bi))
    rate = (2.0 * math.pi * q_scale) * sigma
    depth = torch.exp(-rate[..., None] * z_ang) @ z_w
    return 0.5 * torch.sum(exc * sigma * depth, dim=1)


def channeling_intensities(
    dirs: np.ndarray,
    beams: DynamicalBeams,
    depth_nm: float = 50.0,
    absorption_ratio: float = 0.1,
    chunk: int = 2048,
    depth_centers_nm: np.ndarray | None = None,
    depth_weights: np.ndarray | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Backscatter channeling yield I(d) for unit directions ``dirs``
    (..., 3) in the crystal frame: the master pattern evaluated pointwise.

    Args:
        dirs: exit directions, any leading shape.
        beams: from `dynamical_beams`.
        depth_nm: exponential backscatter-generation depth scale z₀, nm;
            ignored when a measured distribution is passed.
        absorption_ratio: κ = U'₀/U₀ of the site-localized imaginary
            potential (0.05–0.15 typical).
        chunk: directions per device pass (bounds the ``(chunk, N, N)``
            ``eigh`` batch); the last chunk is padded to it.
        depth_centers_nm / depth_weights: optional MEASURED generation-
            depth histogram (both or neither; same length; weights are
            normalized here), e.g. a `sim.montecarlo` energy bin's row.
        mesh: optional `parallel.Mesh`: each chunk shards over its devices;
            ``chunk`` must divide by the mesh size.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.

    Returns ``dirs.shape[:-1]`` float32 intensities (host numpy).
    """
    if (depth_centers_nm is None) != (depth_weights is None):
        raise ValueError("pass depth_centers_nm and depth_weights together (or neither)")
    dev = chunk_device(mesh, device, chunk)
    d = np.asarray(dirs, np.float32)
    lead = d.shape[:-1]
    d = d.reshape(-1, 3)
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    # The Lambert grid's exact corners map to the zero vector; send them to
    # the pole rather than NaN (render_from_master never samples them).
    d = np.where(norm > 1e-12, d / np.maximum(norm, 1e-12), [0.0, 0.0, 1.0])
    n = len(d)

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    g, coupling, bs = dev32(beams.g), dev32(beams.coupling), dev32(beams.backscatter)
    ci = bi = z_ang = z_w = None
    if not beams.is_centrosymmetric:
        ci, bi = dev32(beams.coupling_imag), dev32(beams.backscatter_imag)
    q_scale = float(absorption_ratio * beams.u0 / (2.0 * beams.k_int))  # 1/Å per unit sigma
    z0 = float(depth_nm * 10.0)  # nm → Å
    if depth_centers_nm is not None:
        zc = np.asarray(depth_centers_nm, np.float64)
        zw = np.asarray(depth_weights, np.float64)
        if zc.ndim != 1 or zc.shape != zw.shape:
            raise ValueError(
                "depth_centers_nm/depth_weights must be matching 1-D "
                f"arrays, got {zc.shape} vs {zw.shape}"
            )
        total = zw.sum()
        if not total > 0:
            raise ValueError("depth_weights must have positive mass")
        z_ang, z_w = dev32(zc * 10.0), dev32(zw / total)  # nm → Å
    k_int = beams.k_int

    def run(dc, g, coupling, bs, ci, bi, z_ang, z_w):
        if depth_centers_nm is not None:
            if beams.is_centrosymmetric:
                return _channel_chunk_quad(dc, g, coupling, bs, z_ang, z_w, k_int, q_scale)
            return _channel_chunk_hermitian_quad(
                dc, g, coupling, ci, bs, bi, z_ang, z_w, k_int, q_scale
            )
        if beams.is_centrosymmetric:
            return _channel_chunk(dc, g, coupling, bs, k_int, q_scale, z0)
        return _channel_chunk_hermitian(dc, g, coupling, ci, bs, bi, k_int, q_scale, z0)

    tables = (g, coupling, bs, ci, bi, z_ang, z_w)
    copies = None if mesh is None else replicate(tables, mesh)
    parts = []
    with full_f32_matmul():
        for start in range(0, n, chunk):
            dc = d[start : start + chunk]
            m = len(dc)
            if m < chunk:  # pad to the chunk shape, as the JAX package does
                dc = np.concatenate([dc, np.tile(dc[-1:], (chunk - m, 1))])
            if mesh is None:
                res = run(dev32(dc), *tables)
            else:
                res = map_blocks(run, [np.ascontiguousarray(dc, np.float32)], copies, mesh)
            parts.append(res[:m])
    out = torch.cat(parts).cpu().numpy() if parts else np.empty(0, np.float32)
    return out.reshape(lead)


def lambert_master_directions(size: int) -> np.ndarray:
    """``(size, size, 3)`` float64 directions of a master's pixels in
    `sim.master`'s equal-area convention (row grows with -Y)."""
    half = (size - 1) / 2.0
    ij = (np.arange(size, dtype=np.float64) - half) / half  # [-1, 1]
    x, y = np.meshgrid(ij, -ij, indexing="xy")
    return lambert_to_directions(np.stack([x, y], axis=-1) * np.sqrt(2.0))


def dynamical_master_pattern(
    structure: CrystalStructure,
    kv: float = 20.0,
    size: int = 201,
    n_beams: int = 64,
    depth_nm: float = 50.0,
    absorption_ratio: float = 0.1,
    max_hkl: int = 5,
    min_d: float = 0.4,
    chunk: int = 2048,
    normalize: bool = True,
    beams: DynamicalBeams | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """A north-hemisphere dynamical master pattern: ``(size, size)``
    float32 in `sim.master`'s equal-area convention, ready for
    `render_from_master` and ``cli.index simulate --master``.

    Args:
        structure: from `cubic_structure` / `hexagonal_structure` / custom.
        kv: accelerating voltage, kV.
        size: master image edge, pixels (odd keeps a center pixel).
        n_beams: beam budget for `dynamical_beams` (whole families only).
        depth_nm / absorption_ratio: see `channeling_intensities`.
        max_hkl / min_d: reflection sweep bounds for beam selection.
        chunk: pixels per device pass.
        normalize: min-max normalize to [0, 1].
        beams: a precomputed `dynamical_beams` result (the selection
            arguments are then ignored).
        mesh: optional `parallel.Mesh`: the pixel chunks shard over its
            devices (see `channeling_intensities`).
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.
    """
    if size < 3:
        raise ValueError(f"master size must be >= 3, got {size}")
    dev = chunk_device(mesh, device, chunk)
    if beams is None:
        beams = dynamical_beams(structure, kv=kv, n_beams=n_beams, max_hkl=max_hkl, min_d=min_d)
    img = channeling_intensities(
        lambert_master_directions(size), beams, depth_nm=depth_nm,
        absorption_ratio=absorption_ratio, chunk=chunk, mesh=mesh, device=dev,
    )
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-12)
    return img.astype(np.float32)
