"""Spherical-harmonic indexing: dictionary-free global orientation search.

The port of ``latice_tpu.index.spherical``, the fourth indexing plane beside
latent k-NN, pattern DI and Hough voting: each pattern is back-projected
onto the sphere through the detector geometry and cross-correlated against
the master pattern over ALL of SO(3) at once (the EMSphInx role, on the
`sim.sht` harmonic machinery).

The math (the JAX package's): a pattern ``p(d) = M(Rᵀ d)`` samples the
master M at crystal-frame directions. With the windowed back-projection
``f̂`` of the pattern and the master's coefficients ``m̂``, the correlation on
a ZYZ Euler grid R = Rz(α)Ry(β)Rz(γ) is

    X(α, β_k, γ) = Re Σ_{m≥0} c_m Σ_ν W_mν(β_k) e^{−i(mα+νγ)},
    W_mν(β_k)    = Σ_l conj(f̂_lm) m̂_lν d^l_mν(β_k)

with ``c_0 = 1, c_{m>0} = 2`` (the pattern and master are real, so only the
m ≥ 0 half is computed) and only the degrees l that carry master energy
(odd l vanish for every centrosymmetric master).

Per chunk of patterns, the JAX package's five contractions, four as
matrix products laid out so that no large tensor is copied between them
and the fifth as indexing:

1. projection, pixels → f̂: ``torch.mm`` of the transposed table
   ``(L·2·n_l, D)`` with the normalized patterns, written as ``(m, [re,
   im], l, b)`` so that step 2 reads it per m without a copy;
2. l-contraction, f̂ → W: two ``torch.bmm`` over the batch of m against the
   block tables ``[[m̂r·d; m̂i·d]]`` and ``[[m̂i·d; −m̂r·d]]``, written into
   one ``(re/im, m, b, k, ν)`` buffer, which is the α-DFT's operand;
3. α-DFT over the stacked (re/im, m) rows: one ``torch.bmm`` over the
   (b, k) batch against the shared ``(a·t, 2L)`` table (both output
   components t as rows), which writes ``(b, k, a, t, ν)``;
4. γ-DFT over (t, ν): one ``torch.mm`` into the volume ``(b, k, a, g)``;
5. Newton's β-row selection: plain indexing of the float32 W rows.

On the card the tables are bf16 residents and every product accumulates in
float32, as the JAX package does on an accelerator
(``preferred_element_type=float32``). Where the JAX package keeps a float32
result, the product asks for it with ``out_dtype=torch.float32`` (step 2
under Newton, whose rows must not be rounded; step 4 in the grid, parabolic
and ambiguity modes); where it rounds the float32 result to the tables'
dtype before the next product (steps 1 and 3; steps 2 and 4 otherwise), the
product returns bf16, which is the same float32 accumulation rounded once.
On the CPU everything is float32 with true float32 products
(`device.full_f32_matmul`), as the JAX package runs on its CPU.

Newton's derivatives are written out: X is a finite trig series in (α, γ)
and a quartic Lagrange interpolation in β over 5 grid rows, so its gradient
and Hessian are sums of the same terms.

With ``mesh=`` the tables are copied to every device of the mesh and each
pattern chunk splits over the devices, the per-device results gathered on
the first one.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from latice_tpu_torch.crystal.sampling import reduce_to_fundamental_zone
from latice_tpu_torch.crystal.symmetry import ROTATION_GROUPS
from latice_tpu_torch.device import full_f32_matmul
from latice_tpu_torch.index.knn import topk_lower_index_first
from latice_tpu_torch.parallel.mesh import chunk_device, gather_rows, replicate, shard_batch
from latice_tpu_torch.sim.geometry import DetectorGeometry, pixel_directions
from latice_tpu_torch.sim.master import directions_to_lambert
from latice_tpu_torch.sim.sht import (
    gauss_legendre_ring_grid,
    sph_coeffs_dense,
    sph_matrix_dense,
    wigner_d_table,
)

__all__ = [
    "MultiPhaseSphericalIndexer",
    "MultiPhaseSphericalResult",
    "SphericalIndexer",
    "SphericalIndexerConfig",
    "SphericalResult",
    "master_sph_coefficients",
    "projection_tables",
]

logger = logging.getLogger(__name__)


def _lookup_master(master: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Bilinear master lookup at unit directions (`sim.master` equal-area
    convention, antipodal for z < 0), host float64."""
    m = np.asarray(master, np.float64)
    n = m.shape[0]
    half = (n - 1) / 2.0
    xy = directions_to_lambert(dirs)
    col = np.clip(xy[..., 0] / np.sqrt(2.0) * half + half, 0.0, n - 1.0)
    row = np.clip(-xy[..., 1] / np.sqrt(2.0) * half + half, 0.0, n - 1.0)
    r0 = np.floor(row).astype(np.int64)
    c0 = np.floor(col).astype(np.int64)
    r1 = np.minimum(r0 + 1, n - 1)
    c1 = np.minimum(c0 + 1, n - 1)
    fr = row - r0
    fc = col - c0
    return (
        m[r0, c0] * (1 - fr) * (1 - fc)
        + m[r0, c1] * (1 - fr) * fc
        + m[r1, c0] * fr * (1 - fc)
        + m[r1, c1] * fr * fc
    )


def master_sph_coefficients(master: np.ndarray, bandwidth: int) -> np.ndarray:
    """Dense (L, 2L−1) complex SH coefficients of a master image, analyzed
    over the full sphere on a Gauss–Legendre grid (southern directions via
    the antipode, `render_from_master`'s rule), DC removed and
    unit-normalized so correlation peaks are a cosine-like score."""
    dirs, w = gauss_legendre_ring_grid(bandwidth)
    vals = _lookup_master(master, dirs)
    coef = sph_coeffs_dense(vals, dirs, w, bandwidth)
    coef[0, :] = 0.0  # remove DC: patterns are zero-meaned too
    norm = np.sqrt(np.sum(np.abs(coef) ** 2))
    if norm < 1e-12:
        raise ValueError("master has no harmonic content below bandwidth")
    return coef / norm


def _solid_angle_weights(geometry: DetectorGeometry) -> np.ndarray:
    """Per-pixel solid angles (H·W,): the quadrature weights of the windowed
    back-projection (tilt is a rigid rotation about the source, so the
    untilted gnomonic formula is exact)."""
    h, w = geometry.shape
    col = (np.arange(w, dtype=np.float64) + 0.5) / w
    dist_bottom = (h - (np.arange(h, dtype=np.float64) + 0.5)) / w
    x = col[None, :] - geometry.pcx
    y = dist_bottom[:, None] - geometry.pcy
    r2 = x * x + y * y + geometry.dd**2
    omega = (geometry.dd / (w * w)) / r2**1.5
    return np.broadcast_to(omega, (h, w)).reshape(-1).copy()


@dataclasses.dataclass(frozen=True)
class SphericalIndexerConfig:
    """Knobs of the spherical cross-correlation.

    Attributes:
        bandwidth: harmonic band limit L; the grid spacing is ~180°/L.
        beta_count / alpha_count: SO(3) grid sizes over β ∈ (0, π) and
            α, γ ∈ [0, 2π) (default 2L each).
        detector_bin: mean-pool factor applied on the device before the
            projection.
        chunk: patterns per device pass (bounds the (chunk, K, nA, nG)
            volume: 537 MB float32 at the defaults).
        symmetry: proper rotation group of the fundamental-zone reduction.
        refine: ``"newton"`` (default, also ``True``): damped Newton on the
            continuous band-limited correlation; ``"parabolic"``: 3-point
            host interpolation of the grid peak; ``False``: grid solutions.
        newton_steps: Newton iterations of the ``"newton"`` mode.
    """

    bandwidth: int = 64
    beta_count: int | None = None
    alpha_count: int | None = None
    detector_bin: int = 2
    chunk: int = 64
    symmetry: str = "432"
    refine: bool | str = "newton"
    newton_steps: int = 8

    def __post_init__(self):
        if self.bandwidth < 4:
            raise ValueError(f"bandwidth must be >= 4, got {self.bandwidth}")
        if self.detector_bin < 1:
            raise ValueError("detector_bin must be >= 1")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        if self.symmetry not in ROTATION_GROUPS:
            raise ValueError(
                f"unknown point group {self.symmetry!r}; choose from {sorted(ROTATION_GROUPS)}"
            )
        if self.refine not in (True, False, "newton", "parabolic"):
            raise ValueError(
                f"refine must be True/False/'newton'/'parabolic', got {self.refine!r}"
            )

    @property
    def refine_mode(self) -> str:
        """Canonical mode string: 'newton' | 'parabolic' | 'off'."""
        if self.refine in (True, "newton"):
            return "newton"
        return "parabolic" if self.refine == "parabolic" else "off"


@dataclasses.dataclass(frozen=True)
class SphericalResult:
    """Batch result: scalar-first crystal→detector quaternions (FZ
    representatives), zxz Euler degrees and the correlation score."""

    quaternions: np.ndarray
    eulers_deg: np.ndarray
    scores: np.ndarray

    def __len__(self) -> int:
        return len(self.quaternions)


def _product(a: torch.Tensor, b: torch.Tensor, f32: bool, out: torch.Tensor | None = None):
    """``torch.mm``/``torch.bmm`` of ``a`` and ``b`` (into ``out`` when
    given). bf16 operands accumulate in float32 and return float32 with
    ``f32``, else bf16 (the float32 sum rounded once); float32 operands run
    as true float32 products."""
    op = torch.mm if a.dim() == 2 else torch.bmm
    kw = {} if out is None else {"out": out}
    if a.dtype == torch.float32:
        with full_f32_matmul():
            return op(a, b, **kw)
    if f32:
        kw["out_dtype"] = torch.float32
    return op(a, b, **kw)


def _normalize(pats: torch.Tensor, wvec: torch.Tensor, bin_factor: int) -> torch.Tensor:
    """(b, H, W) float32/uint8 patterns → (b, D) float32, binned, windowed
    zero-mean with unit solid-angle-weighted mass (X becomes a cosine)."""
    b = pats.shape[0]
    x = pats.float()
    if pats.dtype == torch.uint8:
        x = x / 255.0
    if bin_factor > 1:
        hb, wb = x.shape[1] // bin_factor, x.shape[2] // bin_factor
        x = x.reshape(b, hb, bin_factor, wb, bin_factor).mean(dim=(2, 4))
    x = x.reshape(b, -1)
    with full_f32_matmul():
        mean = (x @ wvec) / wvec.sum()
        xc = x - mean[:, None]
        norm = torch.sqrt(torch.clamp((xc * xc) @ wvec, min=1e-20))
    return xc / norm[:, None]


def _project(xcn: torch.Tensor, yt: torch.Tensor, n_m: int) -> torch.Tensor:
    """Step 1: ``f̂`` as ``(L, b, 2·n_l)``: per m, each pattern's [re | im]
    coefficients over the kept degrees (a transposed view of the product's
    ``(L·2·n_l, b)`` output)."""
    ft = _product(yt, xcn.to(yt.dtype).T, False)
    return ft.view(n_m, -1, xcn.shape[0]).transpose(1, 2)


def _l_contract(f: torch.Tensor, br: torch.Tensor, bi: torch.Tensor, f32: bool) -> torch.Tensor:
    """Step 2: ``W`` as ``(2, L, b, K, 2L−1)`` (re, im) from ``f̂`` ``(L, b,
    2·n_l)`` and the block tables ``(L, 2·n_l, K·(2L−1))``."""
    n_m, b, _ = f.shape
    dt = torch.float32 if f32 or br.dtype == torch.float32 else br.dtype
    w = torch.empty((2, n_m, b, br.shape[2]), dtype=dt, device=f.device)
    _product(f, br, f32, out=w[0])
    _product(f, bi, f32, out=w[1])
    return w


def _alpha_dft(w: torch.Tensor, cct: torch.Tensor, k_n: int) -> torch.Tensor:
    """Step 3: ``T2 (b·K, A, 2, 2L−1)`` from ``W`` and the α table ``cct
    (A·2, 2L)`` (rows a, then the component t): per (b, k) one product of
    the shared table with the stacked ``(2L, ν)`` rows of W, in the tables'
    dtype."""
    two, n_m, b, kv = w.shape
    v = kv // k_n
    wv = w.to(cct.dtype).view(two * n_m, b * k_n, v).transpose(0, 1)  # (b·K, 2L, ν)
    t2 = _product(cct.expand(b * k_n, *cct.shape), wv, False)
    return t2.view(b * k_n, cct.shape[0] // 2, 2, v)


def _gamma_dft(t2: torch.Tensor, cgs: torch.Tensor, b: int, k_n: int, f32: bool) -> torch.Tensor:
    """Step 4: the volume ``X (b, K, A, G)`` from ``T2`` and the γ table
    ``cgs (2·(2L−1), G)``: X = Tr·cos + Ti·sin."""
    a_n = t2.shape[1]
    x = _product(t2.view(-1, cgs.shape[0]), cgs, f32)
    return x.view(b, k_n, a_n, cgs.shape[1])


def _grid_peak(xcorr: torch.Tensor):
    """Hierarchical argmax: the γ axis first, then the (k·a) survivor table
    (both take the first maximum, as ``jnp.argmax``). Returns ``(peak, k, a,
    g)``."""
    b, _, a_n, _ = xcorr.shape
    mg, ig = xcorr.max(dim=3)
    flat2 = mg.reshape(b, -1)
    best2 = torch.argmax(flat2, dim=1)
    peak = flat2.gather(1, best2[:, None])[:, 0]
    k = torch.div(best2, a_n, rounding_mode="floor")
    a = best2 % a_n
    g = ig.reshape(b, -1).gather(1, best2[:, None])[:, 0]
    return peak, k, a, g


def _neighborhood(xcorr: torch.Tensor, k, a, g) -> torch.Tensor:
    """The 3×3×3 cells around each peak, β clipped, α and γ wrapped."""
    b, k_n, a_n, g_n = xcorr.shape
    offs = torch.arange(-1, 2, device=xcorr.device)
    kk = torch.clamp(k[:, None] + offs[None, :], 0, k_n - 1)
    aa = (a[:, None] + offs[None, :]) % a_n
    gg = (g[:, None] + offs[None, :]) % g_n
    return xcorr[
        torch.arange(b, device=xcorr.device)[:, None, None, None],
        kk[:, :, None, None],
        aa[:, None, :, None],
        gg[:, None, None, :],
    ]


# Quartic Lagrange basis over the nodes -2..2 and its first two
# derivatives, as products with the powers (1, t, t², t³, t⁴):
# [L_j(t), L_j'(t), L_j''(t)] = powers(t) @ _LAGRANGE_D[:, 5·d + j].
_NODES = np.arange(-2.0, 3.0)
_COEF_T = np.linalg.inv(np.vander(_NODES, 5, increasing=True))  # (power, node)
_DERIV = np.diag(np.arange(1.0, 5.0), 1)  # powers(t) @ _DERIV = powers'(t)
_LAGRANGE_D = np.concatenate([_COEF_T, _DERIV @ _COEF_T, _DERIV @ _DERIV @ _COEF_T], axis=1)
# The series' sums, read from the (6, 6) products of [E0, E1, E2, F0, F1, F2]
# (rows) with the weights [c, c·m, c·ν, −c·m², −c·m·ν, −c·ν²] (columns):
# X, ∇ = (∂t, ∂α, ∂γ) and the Hessian's rows, as flat indices row·6 + col.
_X_AT = 0
_GRAD_AT = [6, 19, 20]
_HESS_AT = [12, 25, 26, 25, 3, 4, 26, 4, 5]


def _series_consts(n_m: int, device, f32: torch.dtype = torch.float32) -> dict:
    """The Newton series' constants for bandwidth ``n_m`` in dtype ``f32``:
    the Lagrange derivative table, the harmonic orders and the (L·ν, 6)
    weights."""
    ms_m = np.arange(0, n_m, dtype=np.float64)[:, None]
    ms_v = np.arange(-(n_m - 1), n_m, dtype=np.float64)[None, :]
    pair = np.where(ms_m == 0, 1.0, 2.0) * np.ones_like(ms_v)
    weights = np.stack([pair, pair * ms_m, pair * ms_v, -pair * ms_m**2, -pair * ms_m * ms_v,
                        -pair * ms_v**2], axis=-1).reshape(-1, 6)
    return dict(
        lagrange=torch.as_tensor(_LAGRANGE_D, dtype=f32, device=device),
        powers=torch.arange(5, dtype=f32, device=device),
        ms_m=torch.as_tensor(ms_m, dtype=f32, device=device),
        ms_v=torch.as_tensor(ms_v, dtype=f32, device=device),
        weights=torch.as_tensor(weights, dtype=f32, device=device),
        x_at=torch.tensor([_X_AT], device=device),
        grad_at=torch.tensor(_GRAD_AT, device=device),
        hess_at=torch.tensor(_HESS_AT, device=device),
    )


def _series(p: torch.Tensor, w5: torch.Tensor, consts: dict):
    """X, its gradient and its Hessian in ``p = (t, α, γ)`` for each pattern:
    ``X = Σ c_m (Wr(t)·cos(mα+νγ) + Wi(t)·sin(mα+νγ))`` with ``W(t)`` the
    quartic interpolation of the 5 rows ``w5 (b, 5, [re, im]·L·ν)``. With
    ``E_d = W_r⁽ᵈ⁾ cos + W_i⁽ᵈ⁾ sin`` and ``F_d = W_i⁽ᵈ⁾ cos − W_r⁽ᵈ⁾ sin``
    (d derivatives in t), every sum is one entry of a (6, 6) product.
    Returns ``(x (b,), grad (b, 3), hess (b, 3, 3))``."""
    b = p.shape[0]
    n_m = consts["ms_m"].shape[0]
    with full_f32_matmul():
        powers = p[:, :1] ** consts["powers"]  # (b, 5)
        lw = (powers @ consts["lagrange"]).view(b, 3, 5)  # L, L', L''
        w = torch.bmm(lw, w5).view(b, 3, 2, n_m, -1)
        wr, wi = w[:, :, 0], w[:, :, 1]
        ang = torch.addcmul(p[:, 2, None, None] * consts["ms_v"], p[:, 1, None, None],
                            consts["ms_m"])
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        e = torch.addcmul(wr * c, wi, s)
        f = torch.addcmul(wi * c, wr, s, value=-1.0)
        sums = (torch.cat([e, f], dim=1).view(b, 6, -1) @ consts["weights"]).view(b, 36)
    return (sums[:, consts["x_at"]][:, 0], sums[:, consts["grad_at"]],
            sums[:, consts["hess_at"]].view(b, 3, 3))


def _newton(w: torch.Tensor, k, a, g, k_n: int, a_n: int, steps: int):
    """Damped Newton on the continuous correlation from each grid peak:
    ``steps`` iterations of ``solve(H + λI, ∇)`` on −X, each clamped to one
    grid cell, β kept within the 5-row stencil, the best point seen kept
    (so the result never scores below the grid). Returns ``(score, beta,
    alpha, gamma)`` in radians."""
    _, n_m, b, kv = w.shape
    v = kv // k_n
    d_beta = np.pi / k_n
    d_alpha = 2.0 * np.pi / a_n
    # A 5-row β stencil of distinct rows near the peak (shifted at the ends:
    # duplicate Lagrange nodes would be singular).
    center = torch.clamp(k, 2, k_n - 3)
    rows = center[:, None] + torch.arange(-2, 3, device=w.device)[None, :]
    bidx = torch.arange(b, device=w.device)[:, None]
    # (b, 5, [re, im], L, ν): the float32 rows, each pattern's own five.
    w5 = w.view(2, n_m, b, k_n, v)[:, :, bidx, rows].permute(2, 3, 0, 1, 4).reshape(b, 5, -1)
    consts = _series_consts(n_m, w.device)
    f32 = torch.float32
    step_lim = torch.tensor([1.0, d_alpha, d_alpha], dtype=f32, device=w.device)
    eye = torch.eye(3, dtype=f32, device=w.device)
    p = torch.stack([(k - center).to(f32), a.to(f32) * d_alpha, g.to(f32) * d_alpha], dim=1)
    x, grad, hess = _series(p, w5, consts)
    best_p, best_v = p, -x
    for _ in range(steps):
        # Derivatives of −X.
        hn, gn = -hess, -grad
        lam = 1e-3 * torch.clamp(hn.diagonal(dim1=1, dim2=2).abs().amax(dim=1), min=1e-6)
        # solve_ex: no singularity check, so no wait for the device per step.
        d = torch.linalg.solve_ex(torch.addcmul(hn, lam[:, None, None], eye), gn)[0]
        p = p - torch.clamp(d, -step_lim, step_lim)
        p[:, 0].clamp_(-2.0, 2.0)
        x, grad, hess = _series(p, w5, consts)
        take = -x < best_v
        best_p = torch.where(take[:, None], p, best_p)
        best_v = torch.where(take, -x, best_v)
    beta = (center.to(f32) + 0.5 + best_p[:, 0]) * d_beta
    return -best_v, beta, best_p[:, 1], best_p[:, 2]


def _correlation_volume(pats, dev: dict, bin_factor: int, w_f32: bool, x_f32: bool):
    """Steps 1-4: ``(b, H, W)`` patterns → ``(xcorr (b, K, A, G), W)``; W is
    float32 with ``w_f32`` (Newton's rows), the volume with ``x_f32``."""
    b = pats.shape[0]
    k_n = dev["k_n"]
    xcn = _normalize(pats, dev["wvec"], bin_factor)
    f = _project(xcn, dev["yt"], dev["br"].shape[0])
    w = _l_contract(f, dev["br"], dev["bi"], w_f32)
    t2 = _alpha_dft(w, dev["cct"], k_n)
    xcorr = _gamma_dft(t2, dev["cgs"], b, k_n, x_f32)
    return xcorr, w


def _top_cells_chunk(pats, dev: dict, bin_factor: int, n_cells: int):
    """Top ``n_cells`` correlation cells per pattern (the ambiguity
    diagnostic's material): γ reduces first, as in the argmax path, then
    `lax.top_k`'s order over the (k·a) survivor table. Returns ``(scores
    (b, P), k, a, g)``, best first."""
    xcorr, _ = _correlation_volume(pats, dev, bin_factor, False, True)
    b, _, a_n, _ = xcorr.shape
    mg, ig = xcorr.max(dim=3)
    vals, idx = topk_lower_index_first(mg.reshape(b, -1), n_cells)
    k = torch.div(idx, a_n, rounding_mode="floor")
    a = idx % a_n
    g = ig.reshape(b, -1).gather(1, idx)
    return vals, k, a, g


def _correlate_chunk(pats, dev: dict, bin_factor: int, refine_mode: str = "grid",
                     newton_steps: int = 8):
    """One chunk of patterns → correlation peak (and refinement).

    ``refine_mode="grid"``: ``(peak, k, a, g, neighborhood (b, 3, 3, 3))``,
    the argmax and its surroundings in float32 for the host's parabolic
    interpolation. ``"newton"``: ``(score, beta, alpha, gamma)`` in radians;
    the volume only locates the basin, so on the card it is written in bf16
    as the JAX package writes it there.
    """
    newton = refine_mode == "newton"
    xcorr, w = _correlation_volume(pats, dev, bin_factor, newton, not newton)
    peak, k, a, g = _grid_peak(xcorr)
    if not newton:
        return peak, k, a, g, _neighborhood(xcorr, k, a, g)
    del xcorr
    return _newton(w, k, a, g, dev["k_n"], dev["a_n"], newton_steps)


def _parabolic_offset(xm: np.ndarray, x0: np.ndarray, xp: np.ndarray):
    """Sub-grid peak offset of a 3-point parabola, clamped to ±0.5."""
    denom = xm - 2.0 * x0 + xp
    safe = np.abs(denom) > 1e-12
    off = np.where(safe, 0.5 * (xm - xp) / np.where(safe, denom, 1.0), 0.0)
    return np.clip(off, -0.5, 0.5)


def projection_tables(
    bandwidth: int,
    geometry: DetectorGeometry,
    detector_bin: int = 1,
    beta_count: int | None = None,
) -> dict:
    """Phase-independent host tables for `SphericalIndexer` setup: the SH
    projection matrices and the Wigner ``d`` table, which depend only on
    (bandwidth, binned geometry, β grid) and dominate the setup (~40 s at
    L=64 on one core). Build them once and pass ``tables=`` to every
    indexer of that bandwidth and geometry. Returns an opaque dict of full
    float64 arrays (each indexer slices its own master's kept degrees)."""
    L = bandwidth
    h, w = geometry.shape
    if h % detector_bin or w % detector_bin:
        raise ValueError(
            f"detector_bin={detector_bin} does not divide detector shape {geometry.shape}"
        )
    bin_geom = (
        geometry
        if detector_bin == 1
        else dataclasses.replace(geometry, shape=(h // detector_bin, w // detector_bin))
    )
    dirs = pixel_directions(bin_geom).reshape(-1, 3).astype(np.float64)
    omega = _solid_angle_weights(bin_geom)
    yr, yi = sph_matrix_dense(L, dirs, omega)
    k_n = beta_count or 2 * L
    betas = (np.arange(k_n) + 0.5) * (np.pi / k_n)
    return dict(
        bandwidth=L,
        bin_shape=bin_geom.shape,
        omega=omega,
        yr=yr,
        yi=yi,
        betas=betas,
        d=wigner_d_table(L, betas),
    )


def _prepare(patterns: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    p = np.asarray(patterns)
    if p.ndim == 2:
        p = p[None]
    if p.ndim != 3 or p.shape[1:] != tuple(shape):
        raise ValueError(f"expected (B, {shape[0]}, {shape[1]}) patterns, got {p.shape}")
    return p if p.dtype == np.uint8 else p.astype(np.float32)


class SphericalIndexer:
    """Index patterns by spherical cross-correlation against a master.

    Args:
        master: ``(N, N)`` master in `sim.master`'s equal-area convention.
        geometry: detector description the patterns were captured with.
        config: `SphericalIndexerConfig`.
        mesh: optional `parallel.Mesh`: the tables are replicated and each
            pattern chunk shards over the devices; ``config.chunk`` must
            divide by the mesh size.
        tables: optional `projection_tables` of this bandwidth, binned
            shape and β grid, shared between indexers.
        device: ``cuda`` unless given; a missing CUDA device raises. With
            ``mesh``, the mesh's first device or None.

    Setup is one-time per (master, geometry): the master's harmonic
    analysis, the Wigner ``m̂·d`` block tables and the projection matrix,
    bf16 on the card (~0.3 GB at L=64) and float32 on the CPU.
    """

    def __init__(
        self,
        master: np.ndarray,
        geometry: DetectorGeometry | None = None,
        config: SphericalIndexerConfig | None = None,
        mesh=None,
        tables: dict | None = None,
        device: str | torch.device | None = None,
    ):
        self.config = config or SphericalIndexerConfig()
        cfg = self.config
        self.mesh = mesh
        self.device = chunk_device(mesh, device, cfg.chunk)
        self.geometry = geometry or DetectorGeometry()
        L = cfg.bandwidth
        h, w = self.geometry.shape
        if h % cfg.detector_bin or w % cfg.detector_bin:
            raise ValueError(
                f"detector_bin={cfg.detector_bin} does not divide detector shape "
                f"{self.geometry.shape}"
            )
        if tables is None:
            tables = projection_tables(L, self.geometry, cfg.detector_bin, cfg.beta_count)
        elif (
            tables["bandwidth"] != L
            or tables["bin_shape"] != (h // cfg.detector_bin, w // cfg.detector_bin)
            or len(tables["betas"]) != (cfg.beta_count or 2 * L)
        ):
            raise ValueError(
                "precomputed tables do not match this indexer's (bandwidth, binned shape, "
                "beta grid)"
            )

        coef = master_sph_coefficients(master, L)
        # Keep only the degrees that carry master energy (odd l vanish for
        # every centrosymmetric master).
        l_norm = np.sqrt(np.sum(np.abs(coef) ** 2, axis=1))
        keep = np.flatnonzero(l_norm > 1e-6 * l_norm.max())
        self._l_keep = keep
        logger.info(f"spherical indexer: bandwidth {L}, {len(keep)}/{L} degrees carry master energy")
        n_l = len(keep)

        omega = tables["omega"]
        n_dirs = len(omega)
        m_dim = 2 * L - 1
        # Projection (m ≥ 0 columns of the kept degrees), transposed and
        # ordered (m, [re, im], l): row block m of the product is step 2's
        # operand for m.
        yr = tables["yr"].reshape(n_dirs, L, m_dim)[:, keep, L - 1 :]  # (D, n_l, L)
        yi = tables["yi"].reshape(n_dirs, L, m_dim)[:, keep, L - 1 :]
        yt = np.stack([yr, yi], axis=1).transpose(3, 1, 2, 0).reshape(L * 2 * n_l, n_dirs)

        k_n = len(tables["betas"])
        a_n = cfg.alpha_count or 2 * L
        self._betas = tables["betas"]
        self._alphas = np.arange(a_n) * (2.0 * np.pi / a_n)
        d_tab = tables["d"][:, keep][:, :, L - 1 :, :]  # (K, n_l, L, ν): m ≥ 0 rows
        mk = coef[keep]
        dmr = (d_tab * mk.real[None, :, None, :]).transpose(2, 1, 0, 3)  # (L, n_l, K, ν)
        dmi = (d_tab * mk.imag[None, :, None, :]).transpose(2, 1, 0, 3)
        # wr = fr·dmr + fi·dmi, wi = fr·dmi − fi·dmr over the stacked [fr | fi].
        br = np.concatenate([dmr, dmi], axis=1).reshape(L, 2 * n_l, k_n * m_dim)
        bi = np.concatenate([dmi, -dmr], axis=1).reshape(L, 2 * n_l, k_n * m_dim)
        # α-DFT over the stacked [Wr; Wi] rows with the pair weights c_m:
        # Tr = Σ c_m (cos mα · Wr + sin mα · Wi), Ti = Σ c_m (cos mα · Wi − sin mα · Wr).
        ms_half = np.arange(0, L, dtype=np.float64)
        pair = np.where(ms_half == 0, 1.0, 2.0)[:, None]
        ang_a = ms_half[:, None] * self._alphas[None, :]
        cm, sm = pair * np.cos(ang_a), pair * np.sin(ang_a)
        cct = np.stack([np.concatenate([cm, sm]).T, np.concatenate([-sm, cm]).T], axis=1)
        cct = cct.reshape(2 * a_n, 2 * L)  # rows (a, t)
        # γ-DFT: X = Σ_ν Tr cos νγ + Ti sin νγ, rows (t, ν).
        ms_full = np.arange(-(L - 1), L, dtype=np.float64)
        ang_g = ms_full[:, None] * self._alphas[None, :]
        cgs = np.concatenate([np.cos(ang_g), np.sin(ang_g)])  # (2·(2L−1), G)

        tdt = torch.float32 if self.device.type == "cpu" else torch.bfloat16

        def put(arr, dtype=tdt):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, dtype)

        self._dev = dict(
            wvec=put(omega, torch.float32),
            yt=put(yt),
            br=put(br),
            bi=put(bi),
            cct=put(cct),
            cgs=put(cgs),
            k_n=k_n,
            a_n=a_n,
        )
        # One copy of the tables per mesh device (the first on the first).
        self._dev_copies = None if mesh is None else replicate(self._dev, mesh)

    def _chunks(self, p: np.ndarray):
        """``(slice, device chunk)`` pairs, the last padded to the chunk
        size with copies of its final pattern (every pass has one shape);
        with a mesh the chunk is its per-device row blocks."""
        chunk = self.config.chunk
        for start in range(0, len(p), chunk):
            pc = p[start : start + chunk]
            m = len(pc)
            if m < chunk:
                pc = np.concatenate([pc, np.repeat(pc[-1:], chunk - m, axis=0)])
            if self.mesh is not None:
                yield slice(start, start + m), m, shard_batch(pc, self.mesh)
            else:
                yield slice(start, start + m), m, torch.from_numpy(pc).to(self.device)

    def _map(self, fn, pc, *args):
        """``fn(chunk, tables, *args)`` on one device, or on each mesh
        device's block with its own tables, the outputs gathered on the
        first device."""
        if self.mesh is None:
            return fn(pc, self._dev, *args)
        outs = [fn(block, tabs, *args) for block, tabs in zip(pc, self._dev_copies)]
        return tuple(gather_rows(parts, self.mesh) for parts in zip(*outs))

    @torch.inference_mode()
    def index_patterns(self, patterns: np.ndarray) -> SphericalResult:
        """Solve orientations for a ``(B, H, W)`` pattern stack (f32 or
        uint8; uint8 is divided by 255 on the device). Returns FZ-reduced
        quaternions, zxz Euler degrees and correlation scores."""
        from scipy.spatial.transform import Rotation as R

        p = _prepare(patterns, self.geometry.shape)
        cfg = self.config
        n = len(p)
        mode = cfg.refine_mode
        peaks = np.empty(n, np.float64)
        if mode == "newton":
            beta, alpha, gamma = (np.empty(n, np.float64) for _ in range(3))
        else:
            ks, as_, gs = (np.empty(n, np.int64) for _ in range(3))
            nbs = np.empty((n, 3, 3, 3), np.float64)
        for sl, m, pc in self._chunks(p):
            if mode == "newton":
                out = self._map(_correlate_chunk, pc, cfg.detector_bin, "newton",
                                cfg.newton_steps)
                for dst, val in zip((peaks, beta, alpha, gamma), out):
                    dst[sl] = val[:m].double().cpu().numpy()
            else:
                out = self._map(_correlate_chunk, pc, cfg.detector_bin)
                for dst, val in zip((peaks, ks, as_, gs, nbs), out):
                    dst[sl] = val[:m].cpu().numpy()

        if mode != "newton":
            d_beta = np.pi / len(self._betas)
            d_alpha = 2.0 * np.pi / len(self._alphas)
            if mode == "parabolic":
                ok = _parabolic_offset(nbs[:, 0, 1, 1], nbs[:, 1, 1, 1], nbs[:, 2, 1, 1])
                oa = _parabolic_offset(nbs[:, 1, 0, 1], nbs[:, 1, 1, 1], nbs[:, 1, 2, 1])
                og = _parabolic_offset(nbs[:, 1, 1, 0], nbs[:, 1, 1, 1], nbs[:, 1, 1, 2])
            else:
                ok = oa = og = 0.0
            beta = (ks + 0.5 + ok) * d_beta
            alpha = (as_ + oa) * d_alpha
            gamma = (gs + og) * d_alpha
        rot = R.from_euler("ZYZ", np.stack([alpha, beta, gamma], axis=1))
        quats = np.roll(rot.as_quat(), 1, axis=1)  # scalar-first
        quats = reduce_to_fundamental_zone(quats, cfg.symmetry)
        eulers = R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz", degrees=True)
        return SphericalResult(
            quaternions=quats.astype(np.float32),
            eulers_deg=eulers.astype(np.float32),
            scores=peaks.astype(np.float32),
        )

    @torch.inference_mode()
    def ambiguity(
        self,
        patterns: np.ndarray,
        n_cells: int = 32,
        min_separation_deg: float | None = None,
    ):
        """Pseudo-symmetry diagnostic from the secondary SO(3) peaks: the
        best *rival* cell (symmetry-reduced disorientation from the winner
        above ``min_separation_deg``, default 2·180°/L) among the top
        ``n_cells`` cells and its score gap, in
        `index.diagnostics.AmbiguityResult`'s vocabulary.

        The cells are ranked after the γ axis is reduced to its maximum, as
        the JAX package ranks them: each (β, α) cell offers only its best γ,
        so a rival sharing a winner's (β, α) is not seen and the gap can
        come out larger than over the full volume. The port keeps the JAX
        package's reduction, so that its gaps are the reference's.
        """
        from scipy.spatial.transform import Rotation as R

        from latice_tpu_torch.index.diagnostics import AmbiguityResult

        if n_cells < 2:
            raise ValueError(f"n_cells must be >= 2, got {n_cells}")
        if min_separation_deg is None:
            min_separation_deg = 2.0 * 180.0 / self.config.bandwidth
        p = _prepare(patterns, self.geometry.shape)
        cfg = self.config
        n = len(p)
        vals = np.empty((n, n_cells), np.float64)
        ks, as_, gs = (np.empty((n, n_cells), np.int64) for _ in range(3))
        for sl, m, pc in self._chunks(p):
            out = self._map(_top_cells_chunk, pc, cfg.detector_bin, n_cells)
            for dst, val in zip((vals, ks, as_, gs), out):
                dst[sl] = val[:m].cpu().numpy()

        # Host: grid cells → rotations → first genuinely different rival.
        d_beta = np.pi / len(self._betas)
        d_alpha = 2.0 * np.pi / len(self._alphas)
        eul = np.stack([as_ * d_alpha, (ks + 0.5) * d_beta, gs * d_alpha], axis=-1).reshape(-1, 3)
        cells = R.from_euler("ZYZ", eul).as_quat().reshape(n, n_cells, 4)
        sym_q = np.roll(ROTATION_GROUPS[cfg.symmetry], -1, axis=1)  # xyzw
        # rel = top⁻¹ ∘ cell for every secondary cell; the symmetry-reduced
        # disorientation from cos(θ_g/2) = |⟨rel, g⟩|.
        top = R.from_quat(np.repeat(cells[:, 0], n_cells - 1, axis=0))
        others = R.from_quat(cells[:, 1:].reshape(-1, 4))
        rel = (top.inv() * others).as_quat()
        cosh = np.abs(rel @ sym_q.T).max(axis=1)
        dis = 2.0 * np.degrees(np.arccos(np.clip(cosh, -1.0, 1.0))).reshape(n, n_cells - 1)
        rival_mask = dis > min_separation_deg
        has = rival_mask.any(axis=1)
        first = np.argmax(rival_mask, axis=1)  # valid only where has
        rows = np.arange(n)
        angle = np.where(has, dis[rows, first], np.nan)
        gap = np.where(has, vals[:, 0] - vals[rows, first + 1], np.nan)
        return AmbiguityResult(angle_deg=angle, score_gap=gap, has_rival=has)


@dataclasses.dataclass(frozen=True)
class MultiPhaseSphericalResult:
    """Multi-phase batch result: the winning phase's solution per pattern
    and the full per-phase score matrix."""

    quaternions: np.ndarray  # (B, 4) scalar-first, winning phase's FZ
    eulers_deg: np.ndarray  # (B, 3) zxz degrees
    scores: np.ndarray  # (B,) winning correlation score
    phase: np.ndarray  # (B,) int64 index into the masters list
    phase_scores: np.ndarray  # (B, K) per-phase peak correlations

    def __len__(self) -> int:
        return len(self.quaternions)


class MultiPhaseSphericalIndexer:
    """Phase discrimination and orientation, dictionary-free: one
    `SphericalIndexer` per candidate master, and per pattern the phase with
    the highest peak (the scores are cosines, comparable across masters).

    Args:
        masters: ``(N, N)`` master images, one per phase.
        geometry: shared detector description.
        config: shared `SphericalIndexerConfig`; per-phase symmetry from
            ``symmetries`` (``config.symmetry`` for every phase otherwise).
        symmetries: optional per-phase proper point groups.
        mesh: optional `parallel.Mesh`, forwarded to every phase's
            `SphericalIndexer`.
        tables: optional `projection_tables`, built here once for all the
            phases when not given.
        device: ``cuda`` unless given; a missing CUDA device raises.
    """

    def __init__(
        self,
        masters,
        geometry: DetectorGeometry | None = None,
        config: SphericalIndexerConfig | None = None,
        symmetries=None,
        mesh=None,
        tables: dict | None = None,
        device: str | torch.device | None = None,
    ):
        masters = list(masters)
        if not masters:
            raise ValueError("need at least one master pattern")
        cfg = config or SphericalIndexerConfig()
        if symmetries is None:
            symmetries = [cfg.symmetry] * len(masters)
        symmetries = list(symmetries)
        if len(symmetries) != len(masters):
            raise ValueError(f"{len(masters)} masters but {len(symmetries)} symmetries")
        self.config = cfg
        self.symmetries = symmetries
        geometry = geometry or DetectorGeometry()
        if tables is None:
            tables = projection_tables(cfg.bandwidth, geometry, cfg.detector_bin, cfg.beta_count)
        self.indexers = [
            SphericalIndexer(m, geometry, dataclasses.replace(cfg, symmetry=s), mesh=mesh,
                             tables=tables, device=device)
            for m, s in zip(masters, symmetries)
        ]

    def index_patterns(self, patterns: np.ndarray) -> MultiPhaseSphericalResult:
        """Solve phase and orientation for a ``(B, H, W)`` stack (f32 or
        uint8): the winning phase's solution per pattern and the ``(B, K)``
        score matrix."""
        results = [ix.index_patterns(patterns) for ix in self.indexers]
        phase_scores = np.stack([r.scores for r in results], axis=1)
        phase = phase_scores.argmax(axis=1)
        rows = np.arange(len(phase))
        quats = np.stack([r.quaternions for r in results], axis=1)
        eulers = np.stack([r.eulers_deg for r in results], axis=1)
        return MultiPhaseSphericalResult(
            quaternions=quats[rows, phase],
            eulers_deg=eulers[rows, phase],
            scores=phase_scores[rows, phase],
            phase=phase.astype(np.int64),
            phase_scores=phase_scores.astype(np.float32),
        )
