"""Geometrically necessary dislocation (GND) density from orientation maps
(the port of ``latice_tpu/crystal/gnd.py``).

With the lattice curvature ``κ_ij = ∂ω_i/∂x_j`` of a 2-D map (ω the lattice
rotation vector in sample coordinates, only in-plane gradients known),
five Nye entries are determined (Pantleon, Scripta Mater. 58 (2008) 994):

    α_12 = κ_21    α_13 = κ_31    α_21 = κ_12    α_23 = κ_32
    α_33 = −κ_11 − κ_22

The density reported is their entrywise norm over the Burgers vector
length, a lower bound on the total GND density. ``x_1`` runs along the map
columns, ``x_2`` along the rows; the relative rotation from pixel a to its
neighbour b is ``g_b⁻¹ ⊗ s ⊗ g_a`` with the symmetry operator s that
minimizes its angle. The forward differences run on the device; those
across a grain boundary and off the map are masked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal.quaternion import from_euler_zxz_deg, quat_mul
from latice_tpu_torch.crystal.symmetry import symmetry_quats
from latice_tpu_torch.device import resolve_device

__all__ = ["GndResult", "gnd_density", "lattice_curvature"]


class GndResult(NamedTuple):
    """Result of `gnd_density` (host arrays, pixel-indexed)."""

    #: GND density lower bound (1/m²); NaN where not measurable.
    density: np.ndarray
    #: The five measurable Nye entries ``(H, W, 5)`` in 1/m, ordered
    #: [α_12, α_13, α_21, α_23, α_33]; NaN where not measurable.
    alpha: np.ndarray
    #: True where both forward differences were within-grain and in-bounds.
    valid: np.ndarray


def _rotation_vector(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis·angle, radians) of unit quaternions (..., 4),
    small-angle safe: ω = v · θ/‖v‖ with θ = 2·atan2(‖v‖, |w|), → 2v."""
    w = q[..., 0].abs()
    v = torch.where(q[..., :1] < 0, -q[..., 1:], q[..., 1:])
    norm = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(norm, w)
    factor = torch.where(norm > 1e-12, theta / torch.clamp(norm, min=1e-12), 2.0)
    return v * factor[..., None]


@torch.no_grad()
def _curvature_fields(euler_deg: torch.Tensor, sym: torch.Tensor, cos_half_threshold: float):
    """(H, W, 3) Euler grid → (omega_east, omega_south) rotation vectors
    (H, W, 3) in radians and (valid_east, valid_south), zero-padded and
    invalid on the last column / row."""
    q = from_euler_zxz_deg(euler_deg)
    conj = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])

    def reduced(qa, qb_conj):
        imgs = quat_mul(sym, qa[..., None, :])  # (..., S, 4)
        rel = quat_mul(qb_conj[..., None, :], imgs)
        best = torch.argmax(rel[..., 0].abs(), dim=-1, keepdim=True)
        rel = torch.gather(rel, -2, best[..., None].expand(*best.shape, 4)).squeeze(-2)
        return _rotation_vector(rel), rel[..., 0].abs()

    pad = torch.nn.functional.pad
    omega_e, cos_e = reduced(q[:, :-1], conj[:, 1:])
    omega_s, cos_s = reduced(q[:-1, :], conj[1:, :])
    valid_e = pad(cos_e >= cos_half_threshold, (0, 1))
    valid_s = pad(cos_s >= cos_half_threshold, (0, 0, 0, 1))
    omega_e = pad(omega_e, (0, 0, 0, 1))
    omega_s = pad(omega_s, (0, 0, 0, 0, 0, 1))
    return omega_e, omega_s, valid_e, valid_s


def lattice_curvature(
    euler_deg: np.ndarray,
    step_um: float = 1.0,
    group: str = "432",
    threshold_deg: float = 5.0,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """In-plane lattice curvature of an ``(H, W, 3)`` zxz Euler-degree map on
    a square grid of ``step_um`` micrometres: ``(kappa_1, kappa_2, valid)``,
    two ``(H, W, 3)`` float64 arrays (``∂ω_i/∂x_1`` east and ``∂ω_i/∂x_2``
    south, rad/m, NaN where masked) and the mask where both are measurable.
    Neighbour disorientations above ``threshold_deg`` are masked."""
    euler = np.asarray(euler_deg, np.float32)
    if euler.ndim != 3 or euler.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) Euler grid, got {euler.shape}")
    if euler.shape[0] < 2 or euler.shape[1] < 2:
        raise ValueError("orientation map must be at least 2x2")
    if step_um <= 0:
        raise ValueError(f"step_um must be positive, got {step_um}")
    dev = resolve_device(device)
    cos_half = float(np.float32(np.cos(np.radians(threshold_deg) / 2.0)))
    omega_e, omega_s, valid_e, valid_s = (
        t.cpu().numpy()
        for t in _curvature_fields(
            torch.as_tensor(euler, device=dev), symmetry_quats(group, device=dev), cos_half
        )
    )
    step_m = float(step_um) * 1e-6
    kappa_1 = omega_e.astype(np.float64) / step_m
    kappa_2 = omega_s.astype(np.float64) / step_m
    kappa_1[~valid_e] = np.nan
    kappa_2[~valid_s] = np.nan
    return kappa_1, kappa_2, valid_e & valid_s


def gnd_density(
    euler_deg: np.ndarray,
    step_um: float = 1.0,
    burgers_nm: float = 0.25,
    group: str = "432",
    threshold_deg: float = 5.0,
    device=None,
) -> GndResult:
    """Measurable-Nye GND density lower bound (1/m²) of an ``(H, W, 3)``
    Euler-degree map with scan step ``step_um`` and Burgers vector
    ``burgers_nm``; differences across ``threshold_deg`` are masked."""
    if burgers_nm <= 0:
        raise ValueError(f"burgers_nm must be positive, got {burgers_nm}")
    kappa_1, kappa_2, valid = lattice_curvature(euler_deg, step_um, group, threshold_deg, device)
    alpha = np.stack(
        [
            kappa_1[..., 1],
            kappa_1[..., 2],
            kappa_2[..., 0],
            kappa_2[..., 2],
            -(kappa_1[..., 0] + kappa_2[..., 1]),
        ],
        axis=-1,
    )
    b_m = float(burgers_nm) * 1e-9
    density = np.sqrt(np.sum(alpha**2, axis=-1)) / b_m
    density[~valid] = np.nan
    return GndResult(density=density, alpha=alpha, valid=valid)
