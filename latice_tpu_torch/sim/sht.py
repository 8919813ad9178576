"""Spherical-harmonic machinery for sphere-domain EBSD indexing.

The port of ``latice_tpu.sim.sht``, numpy only: the host-side (float64)
tables of the spherical cross-correlation indexer
(`latice_tpu_torch.index.spherical`): normalized
associated Legendre recursions, spherical-harmonic projection matrices,
Gauss–Legendre sphere quadrature for master-pattern analysis, and Wigner
little-d tables for the SO(3) correlation. All outputs are dense arrays
shaped for the device's matrix products; nothing here runs per query.

(The reference has no spherical-indexing capability — or any indexing
that does not go through its vector DBs, reference dp_indexer.py:51 — so
this module is part of the beyond-reference EMSphInx-role plane; see
PARITY.md.)

Conventions (pinned by tests/sim/test_sht.py):

* **Spherical harmonics**: orthonormal complex SH with Condon–Shortley
  phase, ``Y_lm(θ,φ) = P̃_lm(cosθ) e^{imφ}``, where P̃ carries the full
  normalization ``sqrt((2l+1)/(4π) · (l−m)!/(l+m)!) · (−1)^m P_lm``;
  ``Y_{l,−m} = (−1)^m conj(Y_lm)`` (matches scipy's ``sph_harm``).
* **Rotation**: ``(Λ(R)f)(n) = f(R⁻¹n)`` with coefficients rotated by
  the Wigner matrix, ``[Λ(R)f]_{lm} = Σ_ν D^l_{mν}(R) f_{lν}``, and for
  ZYZ Euler angles ``R = Rz(α)Ry(β)Rz(γ)`` (intrinsic, scipy "ZYZ"),
  ``D^l_{mν}(α,β,γ) = e^{−imα} d^l_{mν}(β) e^{−iνγ}`` with the standard
  real little-d ``d^l_{mν}(β) = ⟨lm|e^{−iβJ_y}|lν⟩``.
* **Dense coefficient layout**: ``(L, 2L−1)`` with column ``m + L − 1``,
  zero where ``|m| > l`` — the shape every device einsum uses.

The little-d table is computed per degree l as the exact matrix
exponential ``d^l(β) = exp(βG)`` of the real antisymmetric generator
``G = −i J_y`` (``G[m+1,m] = −c₊(m)/2``, ``c₊(m) = sqrt(l(l+1)−m(m+1))``)
via one complex eigendecomposition per l evaluated at all β at once —
no fragile three-term recursions, exactly orthogonal by construction.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

__all__ = [
    "dense_index",
    "gauss_legendre_ring_grid",
    "legendre_table",
    "sph_coeffs_dense",
    "sph_matrix_dense",
    "wigner_d_table",
]


def dense_index(ell: int, m: int, bandwidth: int) -> tuple[int, int]:
    """(row, col) of coefficient (l, m) in the dense (L, 2L−1) layout."""
    if not (0 <= ell < bandwidth and abs(m) <= ell):
        raise ValueError(f"(l={ell}, m={m}) outside bandwidth {bandwidth}")
    return ell, m + bandwidth - 1


def legendre_table(bandwidth: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre values P̃_lm(x) for all l < L, m ≥ 0.

    Returns ``(L, L, len(x))`` float64, entry [l, m] zero for m > l. P̃
    includes the full orthonormal-SH normalization and Condon–Shortley
    phase (module docstring), so ``Y_lm = P̃_lm(cosθ) e^{imφ}``.
    """
    if bandwidth < 1:
        raise ValueError(f"bandwidth must be >= 1, got {bandwidth}")
    x = np.asarray(x, np.float64)
    if np.any(np.abs(x) > 1.0 + 1e-12):
        raise ValueError("legendre argument must be in [-1, 1]")
    x = np.clip(x, -1.0, 1.0)
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))  # sinθ
    out = np.zeros((bandwidth, bandwidth) + x.shape, np.float64)
    # Diagonal seed: P̃_mm = (−1)^m sqrt((2m+1)!!/(4π(2m)!!)) sinθ^m,
    # built multiplicatively to stay finite at high m.
    pmm = np.full(x.shape, 1.0 / np.sqrt(4.0 * np.pi))
    out[0, 0] = pmm
    for m in range(1, bandwidth):
        pmm = pmm * (-np.sqrt((2.0 * m + 1.0) / (2.0 * m))) * s
        out[m, m] = pmm
    # First off-diagonal: P̃_{m+1,m} = x sqrt(2m+3) P̃_mm.
    for m in range(0, bandwidth - 1):
        out[m + 1, m] = x * np.sqrt(2.0 * m + 3.0) * out[m, m]
    # Upward recursion in l at fixed m.
    for m in range(0, bandwidth):
        for ell in range(m + 2, bandwidth):
            a = np.sqrt(
                (4.0 * ell * ell - 1.0) / (ell * ell - m * m)
            )
            b = np.sqrt(
                ((ell - 1.0) ** 2 - m * m)
                / (4.0 * (ell - 1.0) ** 2 - 1.0)
            )
            out[ell, m] = a * (x * out[ell - 1, m] - b * out[ell - 2, m])
    return out


def sph_matrix_dense(
    bandwidth: int, dirs: np.ndarray, weights: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Projection matrices taking point samples to dense SH coefficients.

    For samples ``f_i`` at unit directions ``dirs[i]`` with quadrature
    weights ``w_i``, the dense coefficient estimate is the direct sum
    ``f̂_lm = Σ_i w_i f_i conj(Y_lm(d_i))``; this returns ``(Yr, Yi)``
    each ``(n_points, L·(2L−1))`` float64 such that
    ``f̂ = f @ (Yr + i·Yi)`` reshaped to (L, 2L−1). Exact when the weights
    are a quadrature rule for the sampling (e.g.
    `gauss_legendre_ring_grid`); for detector windows it is the windowed
    projection the spherical indexer correlates with.
    """
    d = np.asarray(dirs, np.float64).reshape(-1, 3)
    n = len(d)
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.clip(norm, 1e-300, None)
    w = (
        np.ones(n, np.float64)
        if weights is None
        else np.asarray(weights, np.float64).reshape(-1)
    )
    if len(w) != n:
        raise ValueError(f"{n} directions vs {len(w)} weights")
    ct = d[:, 2]
    phi = np.arctan2(d[:, 1], d[:, 0])
    p = legendre_table(bandwidth, ct)  # (L, L, n)
    m_dim = 2 * bandwidth - 1
    yr = np.zeros((n, bandwidth, m_dim), np.float64)
    yi = np.zeros((n, bandwidth, m_dim), np.float64)
    c0 = bandwidth - 1
    for m in range(bandwidth):
        cm = np.cos(m * phi) * w
        sm = np.sin(m * phi) * w
        for ell in range(m, bandwidth):
            base = p[ell, m]  # (n,)
            # conj(Y_lm) = P̃ e^{−imφ}
            yr[:, ell, c0 + m] = base * cm
            yi[:, ell, c0 + m] = -base * sm
            if m:
                # conj(Y_{l,−m}) = (−1)^m P̃ e^{+imφ}
                sign = -1.0 if m % 2 else 1.0
                yr[:, ell, c0 - m] = sign * base * cm
                yi[:, ell, c0 - m] = sign * base * sm
    return (
        yr.reshape(n, bandwidth * m_dim),
        yi.reshape(n, bandwidth * m_dim),
    )


def gauss_legendre_ring_grid(
    bandwidth: int, n_lat: int | None = None, n_lon: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Sphere quadrature exact for band-limited integrands.

    Gauss–Legendre nodes in cosθ (exact through polynomial degree
    ``2·n_lat − 1`` ≥ the 2L−2 a squared band-L function reaches) ×
    uniform longitudes (trapezoid — exact for Fourier modes |m| < n_lon).

    Returns ``(dirs (n_lat·n_lon, 3), weights (n_lat·n_lon,))`` with
    ``Σ w = 4π``.
    """
    n_lat = n_lat or bandwidth + 2
    n_lon = n_lon or 4 * bandwidth
    nodes, wq = np.polynomial.legendre.leggauss(n_lat)
    phi = (np.arange(n_lon) + 0.5) * (2.0 * np.pi / n_lon)
    ct, ph = np.meshgrid(nodes, phi, indexing="ij")
    st = np.sqrt(1.0 - ct * ct)
    dirs = np.stack(
        [st * np.cos(ph), st * np.sin(ph), ct], axis=-1
    ).reshape(-1, 3)
    w = np.broadcast_to(
        wq[:, None] * (2.0 * np.pi / n_lon), (n_lat, n_lon)
    ).reshape(-1)
    return dirs, w.copy()


def sph_coeffs_dense(
    values: np.ndarray,
    dirs: np.ndarray,
    weights: np.ndarray,
    bandwidth: int,
) -> np.ndarray:
    """Dense (L, 2L−1) complex coefficients of point samples under a
    quadrature rule — the host-side analysis used for master patterns."""
    yr, yi = sph_matrix_dense(bandwidth, dirs, weights)
    v = np.asarray(values, np.float64).reshape(-1)
    coef = v @ yr + 1j * (v @ yi)
    return coef.reshape(bandwidth, 2 * bandwidth - 1)


def wigner_d_table(
    bandwidth: int, betas: np.ndarray, cache_dir: str | None = None
) -> np.ndarray:
    """Wigner little-d values d^l_{mν}(β) for all l < L at each β.

    Returns ``(len(betas), L, 2L−1, 2L−1)`` float64 in the dense layout
    (rows m, cols ν, both offset by L−1; zero where |m| or |ν| > l).
    Computed as ``exp(βG)`` per degree via one eigendecomposition of the
    real antisymmetric generator (module docstring) — orthogonal to
    machine precision at every β, no recursion error growth.

    ``cache_dir`` (default: the ``LATICE_TPU_TORCH_SHT_CACHE`` env var)
    caches the table on disk keyed by (L, β grid), in files of this
    package's own name (``port_wigner_*``; the JAX package's are never
    read) — the build is the dominant
    indexer-setup cost at production bandwidths (~40 s at L=64, K=128 on
    one core). Cached in float64: an f32 cache once made results depend
    on whether the table came from the cache or a fresh build (the r5
    flaky-pin incident) — the cache must be value-transparent.
    """
    betas = np.atleast_1d(np.asarray(betas, np.float64))
    if cache_dir is None:
        cache_dir = os.environ.get("LATICE_TPU_TORCH_SHT_CACHE") or None
    cache_path = None
    if cache_dir:
        key = zlib.crc32(betas.tobytes()) & 0xFFFFFFFF
        # "f64" suffix: ignores stale float32-era cache files (docstring).
        cache_path = os.path.join(
            cache_dir, f"port_wigner_L{bandwidth}_K{len(betas)}_{key:08x}_f64.npz"
        )
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                if np.array_equal(z["betas"], betas):
                    return z["d"].astype(np.float64)
    k = len(betas)
    m_dim = 2 * bandwidth - 1
    c0 = bandwidth - 1
    out = np.zeros((k, bandwidth, m_dim, m_dim), np.float64)
    out[:, 0, c0, c0] = 1.0
    for ell in range(1, bandwidth):
        n = 2 * ell + 1
        ms = np.arange(-ell, ell + 1, dtype=np.float64)
        cplus = np.sqrt(ell * (ell + 1.0) - ms[:-1] * (ms[:-1] + 1.0))
        g = np.zeros((n, n), np.float64)
        g[np.arange(1, n), np.arange(n - 1)] = -cplus / 2.0
        g[np.arange(n - 1), np.arange(1, n)] = cplus / 2.0
        lam, v = np.linalg.eig(g)  # eigenvalues purely imaginary
        vinv = np.linalg.inv(v)
        e = np.exp(betas[:, None] * lam[None, :])  # (k, n)
        d = np.einsum("mj,kj,jn->kmn", v, e, vinv).real
        sl = slice(c0 - ell, c0 + ell + 1)
        out[:, ell, sl, sl] = d
    if cache_path:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache_path + f".tmp{os.getpid()}.npz"
            np.savez(tmp, d=out, betas=betas)
            os.replace(tmp, cache_path)
        except OSError:
            pass  # cache is best-effort
    return out
