"""Orientation distribution functions: kernel density on SO(3), texture
index and φ2 sections (the port of ``latice_tpu/crystal/odf.py``).

The ODF ``f(g)``, in multiples of the uniform texture, is estimated with the
de la Vallée Poussin kernel

    K_κ(ω) = C(κ) · cos^{2κ}(ω/2),   C(κ) = √π · Γ(κ+2) / Γ(κ+1/2),

ω the misorientation angle, so a uniform orientation set evaluates to
f ≡ 1. Symmetry enters exactly: f(g) is the mean over samples i and
operators s of K(ω(g, s·g_i)), with q ≅ -q through |dot|. Since
cos(ω/2) = |⟨q_g, s ⊗ q_i⟩| = |⟨s⁻¹ ⊗ g, q_i⟩|, evaluation is one product of
the symmetry-expanded points against the samples, a power and a mean.

The product ``(P·S, N)`` does not fit at a real map size (texture_index's
16,384 points x 24 operators x 1,048,576 pixels is 1.6 TB in f32), so
`_odf_values` tiles it over points and over samples and accumulates the
sum over the samples in f32 tile by tile.
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
    "ODF",
    "evaluate_odf",
    "halfwidth_to_kappa",
    "make_odf",
    "odf_sections",
    "texture_index",
]

#: Bytes of the largest per-tile intermediate, the ``(points·S, samples)``
#: kernel matrix.
TILE_BYTES = 1 << 30
#: Samples per tile; the points per tile follow from `TILE_BYTES`.
SAMPLE_TILE = 1 << 16


def halfwidth_to_kappa(halfwidth_deg: float) -> float:
    """Kernel shape κ from the half-width at half-maximum (degrees):
    κ = ln2 / (-2·ln cos(ω_h/2)); 10° gives κ ≈ 91."""
    if not 0 < halfwidth_deg <= 180:
        raise ValueError(f"halfwidth must be in (0, 180] deg, got {halfwidth_deg}")
    c = math.cos(math.radians(halfwidth_deg) / 2.0)
    return math.log(2.0) / (-2.0 * math.log(c))


def _kernel_norm(kappa: float) -> float:
    """C(κ) with ∫ C·cos^{2κ}(ω/2) dg = 1 over normalized Haar measure."""
    from scipy.special import gammaln

    return float(np.exp(0.5 * np.log(np.pi) + gammaln(kappa + 2.0) - gammaln(kappa + 0.5)))


class ODF(NamedTuple):
    """A kernel-density ODF model (host arrays; evaluation runs on a device)."""

    #: (N, 4) unit sample quaternions, scalar-first, float32.
    samples: np.ndarray
    #: (N,) normalized weights (sum 1), e.g. grain areas; uniform if None.
    weights: np.ndarray | None
    #: de la Vallée Poussin kernel shape.
    kappa: float
    #: Proper rotation point group name.
    group: str


def make_odf(
    euler_deg: np.ndarray,
    group: str = "432",
    halfwidth_deg: float = 10.0,
    weights: np.ndarray | None = None,
    device=None,
) -> ODF:
    """A kernel-density ODF of measured ``(..., 3)`` zxz Euler-degree
    orientations with half-width ``halfwidth_deg`` and optional
    non-negative weights (normalized here)."""
    euler = np.asarray(euler_deg, np.float32).reshape(-1, 3)
    if len(euler) == 0:
        raise ValueError("no orientations given")
    dev = resolve_device(device)
    with torch.no_grad():
        q = from_euler_zxz_deg(torch.as_tensor(euler, device=dev)).cpu().numpy()
    w = None
    if weights is not None:
        w = np.asarray(weights, np.float64).reshape(-1)
        if len(w) != len(euler):
            raise ValueError(f"{len(w)} weights for {len(euler)} orientations")
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be non-negative with positive sum")
        w = (w / w.sum()).astype(np.float32)
    symmetry_quats(group)  # an unknown group raises here
    return ODF(samples=q, weights=w, kappa=halfwidth_to_kappa(halfwidth_deg), group=group)


@torch.no_grad()
def _odf_values(points, samples, weights, sym, kappa: float, norm: float) -> torch.Tensor:
    """(P, 4) points, (N, 4) samples, (N,) weights, (S, 4) operators →
    (P,) ODF values, tiled over points and samples."""
    expanded = quat_mul(quat_inv(sym)[None, :, :], points[:, None, :])  # (P, S, 4)
    p, s, _ = expanded.shape
    n = len(samples)
    n_tile = min(n, SAMPLE_TILE)
    p_tile = max(1, TILE_BYTES // (s * n_tile * 4))
    out = torch.zeros(p, dtype=torch.float32, device=points.device)
    for p0 in range(0, p, p_tile):
        rows = expanded[p0:p0 + p_tile].reshape(-1, 4)
        for n0 in range(0, n, n_tile):
            # Full f32: the dot feeds cos^{2κ} with κ ~ 10², where a
            # TF32-level error δ near dot = 1 scales the kernel by e^{2κδ}.
            with full_f32_matmul():
                dots = rows @ samples[n0:n0 + n_tile].T
            # cos^{2κ} as a power of |dot| floored at 1e-30, as JAX takes it.
            k = dots.abs_().clamp_(min=1e-30).pow_(2.0 * kappa)
            k = k.view(-1, s, k.shape[-1]).mean(dim=1)
            del dots  # one tile alive at a time
            with full_f32_matmul():
                out[p0:p0 + p_tile] += k @ weights[n0:n0 + n_tile]
    return norm * out


def _evaluate(odf: ODF, q: np.ndarray, dev: torch.device) -> np.ndarray:
    n = len(odf.samples)
    w = odf.weights if odf.weights is not None else np.full(n, 1.0 / n, np.float32)
    return _odf_values(
        torch.as_tensor(q, device=dev),
        torch.as_tensor(odf.samples, device=dev),
        torch.as_tensor(w, device=dev),
        symmetry_quats(odf.group, device=dev),
        float(np.float32(odf.kappa)),
        float(np.float32(_kernel_norm(odf.kappa))),
    ).cpu().numpy()


def evaluate_odf(odf: ODF, euler_deg: np.ndarray, device=None) -> np.ndarray:
    """ODF values (multiples of uniform) at zxz Euler points ``(..., 3)``."""
    euler = np.asarray(euler_deg, np.float32)
    lead = euler.shape[:-1]
    dev = resolve_device(device)
    with torch.no_grad():
        q = from_euler_zxz_deg(torch.as_tensor(euler.reshape(-1, 3), device=dev))
    return _evaluate(odf, q, dev).reshape(lead)


def texture_index(odf: ODF, n: int = 16384, seed: int = 0, device=None) -> float:
    """Texture index J = ∫ f(g)² dg (1 = random), by Monte Carlo over ``n``
    Haar-uniform orientations (Shoemake map, the JAX package's draws). It is
    the index of the kernel-smoothed ODF, so compare values only at equal
    half-widths."""
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
    vals = _evaluate(odf, q, resolve_device(device))
    return float(np.mean(np.square(vals)))


def odf_sections(
    odf: ODF,
    phi2_deg: Sequence[float] = (0.0, 45.0, 65.0),
    phi1_max_deg: float = 90.0,
    phi_max_deg: float = 90.0,
    resolution_deg: float = 2.5,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant-φ2 ODF sections: ``(sections, phi1_axis, phi_axis)`` with
    ``sections`` of shape ``(len(phi2_deg), len(phi_axis), len(phi1_axis))``
    (Φ down the rows, φ1 across)."""
    phi1 = np.arange(0.0, phi1_max_deg + 1e-6, resolution_deg, dtype=np.float32)
    phi = np.arange(0.0, phi_max_deg + 1e-6, resolution_deg, dtype=np.float32)
    p1, p = np.meshgrid(phi1, phi)
    out = np.empty((len(phi2_deg), *p1.shape), np.float32)
    for i, phi2 in enumerate(phi2_deg):
        pts = np.stack([p1, p, np.full_like(p1, phi2)], axis=-1)
        out[i] = evaluate_odf(odf, pts, device=device)
    return out, phi1, phi
