"""Gradient-based orientation refinement through the differentiable renderer.

The port of ``latice_tpu.sim.refine``. Dictionary indexing cannot beat its
grid spacing; refinement fits each orientation to the pattern itself. The
kinematical render (`sim.kinematical.band_intensity`) is smooth in the
orientation, so the normalized cross-correlation (NCC) between the rendered
and the observed pattern has an exact gradient (``torch.autograd.grad``),
and a few Adam steps on a tangent-space perturbation reach sub-tenth-degree
accuracy from a start inside the bands' basin (~the Bragg angle).

Parameterization: ``q = dq(v) ⊗ q0`` with ``dq(v) = (1, v/2)/|·|`` for a
rotation vector ``v`` (radians), so the iterate stays a unit quaternion and
the learning rate is an angle scale.

The JAX package runs all steps as one ``lax.scan`` program; here each step
is launched from Python: one render forward, its backward and the Adam
update (``chip_smoke.py`` counts the kernels a step launches). The Adam update is the JAX module's own, written out:
b1 0.9, b2 0.999, eps 1e-8, bias corrections at ``i + 1``, and the rate
decayed by ``(1/30) ** (1/(steps-1))`` per step, to lr/30 at the last.
"""

from __future__ import annotations

import numpy as np
import torch

from latice_tpu_torch.device import full_f32_matmul, resolve_device
from latice_tpu_torch.sim.geometry import DetectorGeometry
from latice_tpu_torch.sim.kinematical import (
    Reflectors,
    band_intensity,
    cubic_reflectors,
    model_tensors,
)

__all__ = ["refine_candidates", "refine_orientations"]


def _standardize(x: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit norm per row (the NCC's normalization)."""
    x = x - x.mean(dim=1, keepdim=True)
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)


def _apply_tangent(v: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """q = dq(v) ⊗ q0 for small rotation vectors v (B, 3), radians."""
    dq = torch.cat([torch.ones_like(v[..., :1]), 0.5 * v], dim=-1)
    dq = dq / torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
    a_w, a_xyz = dq[..., :1], dq[..., 1:]
    b_w, b_xyz = q0[..., :1], q0[..., 1:]
    return torch.cat(
        [
            a_w * b_w - (a_xyz * b_xyz).sum(dim=-1, keepdim=True),
            a_w * b_xyz + b_w * a_xyz + torch.linalg.cross(a_xyz, b_xyz, dim=-1),
        ],
        dim=-1,
    )


def _refine_chunk(patterns, q0, consts, lr: float, steps: int, edge_frac: float):
    """Adam on the tangent vector, all queries of the chunk in parallel.
    Returns the refined quaternions and each query's final NCC."""
    p = _standardize(patterns)

    def ncc(v):
        sim = _standardize(band_intensity(_apply_tangent(v, q0), *consts, edge_frac))
        return (sim * p).sum(dim=1)

    b1, b2, eps = 0.9, 0.999, 1e-8
    # Exponential lr decay to lr/30: Adam's sign-normalized steps are
    # ~lr-sized even at the optimum, so a constant rate leaves a random-walk
    # floor; decaying polishes it away.
    decay = (1.0 / 30.0) ** (1.0 / max(steps - 1, 1))
    v = torch.zeros(q0.shape[:-1] + (3,), device=q0.device)
    m, s = torch.zeros_like(v), torch.zeros_like(v)
    for i in range(steps):
        # f32 scalars, as the JAX scan computes them from its f32 counter.
        step = np.float32(i)
        c1 = float(np.float32(1.0) - np.float32(b1) ** (step + np.float32(1.0)))
        c2 = float(np.float32(1.0) - np.float32(b2) ** (step + np.float32(1.0)))
        rate = float(np.float32(lr) * np.float32(decay) ** step)
        v.requires_grad_(True)
        (g,) = torch.autograd.grad(-ncc(v).sum(), v)
        v = v.detach()
        m = b1 * m + (1 - b1) * g
        s = b2 * s + (1 - b2) * g * g
        v = v - rate * (m / c1) / (torch.sqrt(s / c2) + eps)
    with torch.no_grad():
        return _apply_tangent(v, q0), ncc(v)


def refine_orientations(
    patterns: np.ndarray,
    init_quats: np.ndarray,
    geometry: DetectorGeometry | None = None,
    reflectors: Reflectors | None = None,
    steps: int = 40,
    lr: float = 2e-3,
    edge_frac: float = 0.25,
    chunk: int = 64,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Refine orientations against observed patterns by autodiff.

    Args:
        patterns: ``(B, H, W)`` observed patterns (any intensity scale: the
            NCC is affine-invariant).
        init_quats: ``(B, 4)`` scalar-first starts, inside the bands' basin
            (a few degrees), e.g. an indexing result through
            `crystal.from_euler_zxz_deg`.
        geometry / reflectors: the simulation model; the values the
            dictionary was simulated with.
        steps: Adam iterations.
        lr: tangent step scale, radians (2e-3 ≈ 0.11° per step).
        chunk: queries refined together.
        device: ``cuda`` unless given; a missing CUDA device raises.

    Returns:
        ``(refined_quats (B, 4), ncc (B,))`` as host float32; the final NCC
        is a per-query fit score in [-1, 1].
    """
    dev = resolve_device(device)
    geometry = geometry or DetectorGeometry()
    reflectors = reflectors or cubic_reflectors()
    x = np.asarray(patterns, np.float32)
    q0 = np.asarray(init_quats, np.float32)
    if x.ndim != 3:
        raise ValueError(f"expected (B, H, W) patterns, got {x.shape}")
    if q0.shape != (len(x), 4):
        raise ValueError(f"init_quats must be ({len(x)}, 4), got {q0.shape}")
    h, w = geometry.shape
    if x.shape[1:] != (h, w):
        raise ValueError(
            f"patterns are {x.shape[1]}x{x.shape[2]} but the geometry renders {h}x{w}"
        )
    q0 = q0 / np.linalg.norm(q0, axis=1, keepdims=True)
    b = len(x)
    flat = x.reshape(b, -1)
    parts = []
    # Gradients are taken here even when the caller runs under
    # torch.inference_mode or no_grad.
    with torch.inference_mode(False), torch.enable_grad(), full_f32_matmul():
        consts = model_tensors(geometry, reflectors, dev)
        for start in range(0, b, chunk):
            xc = torch.from_numpy(flat[start : start + chunk]).to(dev)
            qc = torch.from_numpy(q0[start : start + chunk]).to(dev)
            parts.append(_refine_chunk(xc, qc, consts, lr, steps, edge_frac))
    if not parts:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    out_q = torch.cat([q for q, _ in parts]).cpu().numpy()
    out_c = torch.cat([c for _, c in parts]).cpu().numpy()
    return out_q, out_c


def refine_candidates(
    patterns: np.ndarray,
    candidate_quats: np.ndarray,
    geometry: DetectorGeometry | None = None,
    reflectors: Reflectors | None = None,
    **refine_kw,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Refine every top-k candidate and keep the best-fitting one per query.

    Args:
        patterns: ``(B, H, W)`` observed patterns.
        candidate_quats: ``(B, K, 4)`` scalar-first candidates, best first.
        geometry / reflectors / **refine_kw: as `refine_orientations`.

    Returns:
        ``(best_quats (B, 4), best_ncc (B,), best_k (B,))``; ``best_k`` is
        the winning candidate's column (0 = the search's top-1).
    """
    cand = np.asarray(candidate_quats, np.float32)
    if cand.ndim != 3 or cand.shape[2] != 4 or cand.shape[1] == 0:
        raise ValueError(f"candidate_quats must be (B, K, 4) with K >= 1, got {cand.shape}")
    b, k, _ = cand.shape
    all_q = np.empty((k, b, 4), np.float32)
    all_c = np.empty((k, b), np.float32)
    for j in range(k):
        all_q[j], all_c[j] = refine_orientations(
            patterns, cand[:, j], geometry, reflectors, **refine_kw
        )
    best = all_c.argmax(axis=0)
    rows = np.arange(b)
    return all_q[best, rows], all_c[best, rows], best
