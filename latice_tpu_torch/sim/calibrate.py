"""Detector geometry calibration by autodiff: fit the pattern center.

The port of ``latice_tpu.sim.calibrate``. The pattern center (pcx, pcy, dd)
is the dominant systematic error of EBSD geometry. Here it is fitted from
ordinary indexed patterns: the shared geometry parameters and per-pattern
orientation corrections jointly maximize the summed normalized
cross-correlation (NCC) between the kinematical render and the patterns.

PC error and a common rotation are locally nearly degenerate (only the
gnomonic distortion separates them), so a shared-PC fit removes ~90% of a
PC error and then creeps; known orientations (``lr_orientation=0``) or the
affine scan model (`calibrate_scan_geometry`) break the degeneracy.

The JAX package runs the Adam loop as one ``lax.scan``; here each step is
launched from Python, as in `sim.refine`: the geometry enters through
`_pixel_directions`, a torch re-expression of `geometry.pixel_directions`,
so ``torch.autograd`` differentiates the render with respect to
(pcx, pcy, dd) as it does with respect to the orientations. The Adam update
is the JAX module's, written out: b1 0.9, b2 0.999, eps 1e-8, bias
corrections at ``i + 1``, one rate per parameter group, each decayed to
1/30 (shared PC) or 1/100 (affine model) of itself at the last step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.device import full_f32_matmul, resolve_device
from latice_tpu_torch.sim.geometry import DetectorGeometry
from latice_tpu_torch.sim.kinematical import Reflectors, band_intensity, cubic_reflectors
from latice_tpu_torch.sim.refine import _apply_tangent, _standardize

__all__ = ["ScanCalibration", "calibrate_geometry", "calibrate_scan_geometry"]


def _pixel_directions(shape, pc: torch.Tensor, tilt_rad: torch.Tensor) -> torch.Tensor:
    """`geometry.pixel_directions` in torch, differentiable in ``pc``:
    ``(..., 3)`` ``[pcx, pcy, dd]`` → ``(..., H*W, 3)`` unit directions."""
    h, w = shape
    dev = pc.device
    col = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    dist_bottom = (h - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)) / w
    pcx, pcy, dd = (pc[..., i, None, None] for i in range(3))
    x = (col[None, :] - pcx).expand(*pc.shape[:-1], h, w)
    y = (dist_bottom[:, None] - pcy).expand(*pc.shape[:-1], h, w)
    z = torch.ones((h, w), device=dev) * dd
    ct, st = torch.cos(tilt_rad), torch.sin(tilt_rad)
    d = torch.stack([x, ct * y - st * z, st * y + ct * z], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d.reshape(*pc.shape[:-1], h * w, 3)


def _adam(loss_fn, params: list[torch.Tensor], lrs: list[float], steps: int, final: float):
    """``steps`` Adam steps on ``params`` (one rate each, decayed to
    ``final`` times itself at the last step); returns the parameters."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    decay = final ** (1.0 / max(steps - 1, 1))
    m = [torch.zeros_like(p) for p in params]
    s = [torch.zeros_like(p) for p in params]
    for i in range(steps):
        # f32 scalars, as the JAX scan computes them from its f32 counter.
        step = np.float32(i)
        c1 = float(np.float32(1.0) - np.float32(b1) ** (step + np.float32(1.0)))
        c2 = float(np.float32(1.0) - np.float32(b2) ** (step + np.float32(1.0)))
        for p in params:
            p.requires_grad_(True)
        grads = torch.autograd.grad(loss_fn(*params), params)
        new = []
        for j, (p, g) in enumerate(zip(params, grads)):
            p = p.detach()
            m[j] = b1 * m[j] + (1 - b1) * g
            s[j] = b2 * s[j] + (1 - b2) * g * g
            rate = float(np.float32(lrs[j]) * np.float32(decay) ** step)
            new.append(p - rate * (m[j] / c1) / (torch.sqrt(s[j] / c2) + eps))
        params = new
    return params


def _calibrate(patterns, q0, pc0, tilt_rad, consts, lr_pc, lr_v, *, shape, steps, edge_frac):
    """Shared-PC fit: returns ``(pc (3,), quats (B, 4), summed NCC)``."""
    p = _standardize(patterns)
    normals, sin_theta, intensity = consts

    def loss(pc, v):
        dirs = _pixel_directions(shape, pc, tilt_rad)
        x = _standardize(
            band_intensity(_apply_tangent(v, q0), dirs, normals, sin_theta, intensity, edge_frac)
        )
        return -(x * p).sum()

    v0 = torch.zeros(q0.shape[:-1] + (3,), device=q0.device)
    pc, v = _adam(loss, [pc0, v0], [lr_pc, lr_v], steps, 1.0 / 30.0)
    with torch.no_grad():
        return pc, _apply_tangent(v, q0), -loss(pc, v)


def _calibrate_scan(patterns, q0, s_xy, pc0, g0, tilt_rad, consts, lr_pc, lr_g, lr_v, *,
                    shape, steps, edge_frac):
    """Joint fit of (PC₀, G, per-pattern tangents) where pattern ``i``
    renders through ``PC₀ + G @ s_xy[i]``: returns ``(pc0, G, quats,
    summed NCC)``."""
    p = _standardize(patterns)
    normals, sin_theta, intensity = consts

    def loss(pc0_, g_, v):
        pc = pc0_[None, :] + s_xy @ g_.T  # (B, 3)
        dirs = _pixel_directions(shape, pc, tilt_rad)  # (B, P, 3)
        x = _standardize(
            band_intensity(_apply_tangent(v, q0), dirs, normals, sin_theta, intensity, edge_frac)
        )
        return -(x * p).sum()

    v0 = torch.zeros(q0.shape[:-1] + (3,), device=q0.device)
    # Decay deeper than the shared-PC fit's: the affine fit runs hundreds of
    # steps and the final rate sets the resolution of the gradient.
    pc0_, g_, v = _adam(loss, [pc0, g0, v0], [lr_pc, lr_g, lr_v], steps, 1.0 / 100.0)
    with torch.no_grad():
        return pc0_, g_, _apply_tangent(v, q0), -loss(pc0_, g_, v)


def _fit_inputs(patterns, init_quats, geometry, reflectors, device):
    """Validated ``(x (B, H*W), q0 (B, 4), tilt, (normals, sin, intensity))``
    tensors on the device."""
    x = np.asarray(patterns, np.float32)
    q0 = np.asarray(init_quats, np.float32)
    if x.ndim != 3 or x.shape[1:] != geometry.shape:
        raise ValueError(
            f"expected (B, {geometry.shape[0]}, {geometry.shape[1]}) patterns, got {x.shape}"
        )
    if q0.shape != (len(x), 4):
        raise ValueError(f"init_quats must be ({len(x)}, 4), got {q0.shape}")
    q0 = q0 / np.linalg.norm(q0, axis=1, keepdims=True)
    consts = tuple(
        torch.as_tensor(a, device=device)
        for a in (reflectors.normals, reflectors.sin_theta, reflectors.intensity)
    )
    return (
        torch.from_numpy(x.reshape(len(x), -1)).to(device),
        torch.from_numpy(q0).to(device),
        torch.tensor(np.radians(geometry.tilt), dtype=torch.float32, device=device),
        consts,
    )


class ScanCalibration(NamedTuple):
    """Affine scan-varying pattern-center model ``PC(xy) = pc0 + G @ xy``.

    ``xy`` is in the SAME units `calibrate_scan_geometry` received
    (``pc0`` sits at the caller's scan origin). `pc_at`/`geometry_at`
    evaluate the model at arbitrary scan positions.
    """

    pc0: np.ndarray  # (3,) [pcx, pcy, dd] at scan origin
    gradient: np.ndarray  # (3, 2) d[pcx, pcy, dd] / d[scan_x, scan_y]
    shape: tuple
    tilt: float

    def pc_at(self, xy) -> np.ndarray:
        """``(..., 2)`` scan positions → ``(..., 3)`` pattern centers."""
        xy = np.asarray(xy, np.float64)
        return self.pc0 + xy @ self.gradient.T

    def geometry_at(self, xy) -> DetectorGeometry:
        """The `DetectorGeometry` at one scan position."""
        pc = self.pc_at(np.asarray(xy, np.float64).reshape(2))
        return DetectorGeometry(
            shape=self.shape, pcx=float(pc[0]), pcy=float(pc[1]),
            dd=float(pc[2]), tilt=self.tilt,
        )


def calibrate_scan_geometry(
    patterns: np.ndarray,
    init_quats: np.ndarray,
    scan_xy: np.ndarray,
    geometry: DetectorGeometry | None = None,
    reflectors: Reflectors | None = None,
    steps: int = 300,
    lr_pc: float = 2e-3,
    lr_gradient: float | None = None,
    lr_orientation: float = 2e-3,
    edge_frac: float = 0.25,
    device: str | torch.device | None = None,
) -> tuple[ScanCalibration, np.ndarray, float]:
    """Fit an affine scan-varying pattern center ``PC(xy) = PC₀ + G·xy``.

    As the beam rasters the sample, the source point moves under a fixed
    detector, so the projection center shifts linearly with the scan
    position. Fitting G jointly with PC₀ and per-pattern orientation
    corrections breaks the PC↔rotation near-degeneracy a shared-PC fit
    has: the affine constraint (9 shared parameters) is strongly
    overdetermined.

    Args:
        patterns: ``(B, H, W)`` calibration patterns spread over the scan.
        init_quats: ``(B, 4)`` indexed orientations (within a few degrees);
            known orientations with ``lr_orientation=0`` pin them.
        scan_xy: ``(B, 2)`` scan positions, any units: the returned gradient
            is per this unit. Positions are centered and scaled to ±1
            internally, for conditioning only.
        geometry: nominal starting geometry (``tilt`` held fixed).
        reflectors / steps / edge_frac: as in `calibrate_geometry`.
        lr_pc: Adam scale of PC₀, detector widths per step.
        lr_gradient: Adam scale of G in normalized scan units; default
            ``lr_pc``.
        lr_orientation: tangent scale of the orientation corrections, rad.
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(ScanCalibration, refined quats (B, 4), mean NCC)``.
    """
    dev = resolve_device(device)
    geometry = geometry or DetectorGeometry()
    reflectors = reflectors or cubic_reflectors()
    s = np.asarray(scan_xy, np.float64)
    x, q0, tilt, consts = _fit_inputs(patterns, init_quats, geometry, reflectors, dev)
    if s.shape != (len(x), 2):
        raise ValueError(f"scan_xy must be ({len(x)}, 2), got {s.shape}")
    # Centered on the centroid, each axis scaled to ±1; the model is
    # converted back to the caller's units below.
    centroid = s.mean(axis=0)
    span = np.abs(s - centroid).max(axis=0)
    span = np.where(span > 0, span, 1.0)  # a constant axis fits G column 0
    s_hat = (s - centroid) / span
    if lr_gradient is None:
        lr_gradient = lr_pc
    pc0 = torch.tensor([geometry.pcx, geometry.pcy, geometry.dd], dtype=torch.float32, device=dev)
    with torch.inference_mode(False), torch.enable_grad(), full_f32_matmul():
        pc0_hat, g_hat, quats, total = _calibrate_scan(
            x, q0, torch.as_tensor(s_hat, dtype=torch.float32, device=dev), pc0,
            torch.zeros((3, 2), device=dev), tilt, consts, lr_pc, lr_gradient, lr_orientation,
            shape=geometry.shape, steps=steps, edge_frac=edge_frac,
        )
    pc0_hat = pc0_hat.cpu().numpy().astype(np.float64)
    g_hat = g_hat.cpu().numpy().astype(np.float64)
    g_user = g_hat / span[None, :]  # undo the axis scaling
    pc0_user = pc0_hat - g_user @ centroid  # move the origin back
    fit = ScanCalibration(pc0=pc0_user, gradient=g_user, shape=geometry.shape, tilt=geometry.tilt)
    return fit, quats.cpu().numpy(), float(total) / len(x)


def calibrate_geometry(
    patterns: np.ndarray,
    init_quats: np.ndarray,
    geometry: DetectorGeometry | None = None,
    reflectors: Reflectors | None = None,
    steps: int = 80,
    lr_pc: float = 2e-3,
    lr_orientation: float = 2e-3,
    edge_frac: float = 0.25,
    device: str | torch.device | None = None,
) -> tuple[DetectorGeometry, np.ndarray, float]:
    """Fit (pcx, pcy, dd) jointly with per-pattern orientation corrections.

    Args:
        patterns: ``(B, H, W)`` calibration patterns: a dozen scan points at
            diverse orientations.
        init_quats: ``(B, 4)`` indexed orientations (within a few degrees).
        geometry: the nominal geometry (the starting point; ``tilt`` is held
            fixed).
        reflectors / steps / edge_frac: as in `sim.refine`.
        lr_pc: Adam scale of the pattern-center parameters, detector widths
            per step.
        lr_orientation: tangent scale of the orientation corrections, rad.
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(calibrated DetectorGeometry, refined quats (B, 4), mean NCC)``.
    """
    dev = resolve_device(device)
    geometry = geometry or DetectorGeometry()
    reflectors = reflectors or cubic_reflectors()
    x, q0, tilt, consts = _fit_inputs(patterns, init_quats, geometry, reflectors, dev)
    pc0 = torch.tensor([geometry.pcx, geometry.pcy, geometry.dd], dtype=torch.float32, device=dev)
    with torch.inference_mode(False), torch.enable_grad(), full_f32_matmul():
        pc, quats, total = _calibrate(
            x, q0, pc0, tilt, consts, lr_pc, lr_orientation,
            shape=geometry.shape, steps=steps, edge_frac=edge_frac,
        )
    pc = pc.cpu().numpy().astype(np.float64)
    fitted = DetectorGeometry(
        shape=geometry.shape, pcx=float(pc[0]), pcy=float(pc[1]), dd=float(pc[2]),
        tilt=geometry.tilt,
    )
    return fitted, quats.cpu().numpy(), float(total) / len(x)
