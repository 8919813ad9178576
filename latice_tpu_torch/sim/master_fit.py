"""Fit the kinematical band model to a master-pattern image.

Round-3 left the two headline accuracy features mutually exclusive:
`query --refine` (autodiff sub-grid refinement, `sim.refine`) needs the
differentiable *band* model, while the highest-fidelity dictionaries are
rendered by pixel lookup from a *master image* (`simulate --master` —
dynamical or EMsoft-imported), which carries no band parameters. This
module closes that gap: it fits the per-reflector weights of
`sim.kinematical`'s differentiable profile model to a master image ONCE
at import time, so the fit can be persisted as refinement provenance and
`simulate --master` → `build` → `query --refine` composes.

Why this is well-posed: in the crystal frame a master image is exactly a
superposition of band profiles — intensity depends on a direction ``d``
only through the band coordinates ``d·n_k``. The refine renderer models a
band as ``sigmoid((sinθ_k − |d·n_k|)/soft_k)``; with the band *geometry*
(normals + Bragg sines) known from the cell, the master fit is linear in
the per-band weights:

    I(d) ≈ c + Σ_k w_k · φ_k(d),   φ_k(d) = sigmoid((sinθ_k − |d·n_k|)/soft_k)

solved by ridge-regularized least squares over every valid master pixel.
Weights are SIGNED by default: dynamical masters have genuinely
negative-contrast (deficit/dark) bands, and the refine objective (NCC) is
affine-invariant, so a negative band weight is a correct, usable model
term — clipping them costs real fit quality (measured on a 40-beam fcc
dynamical master: signed NCC 0.81 vs 0.33 clipped). Pass
``allow_negative=False`` for a non-negative fit (clip + active-set
re-solve) when the weights must feed an intensity-positive consumer.
~40k pixels × a few hundred candidates: one (K, K) host solve,
milliseconds.

The *candidate* band set should come from the **Bravais sublattice** of
the phase (e.g. the fcc cation sublattice for zincblende): lattice-type
extinctions are exact zeros of the master, while basis/species effects
only modulate intensities — which the fit measures directly. NCC-based
refinement is affine-invariant, so only relative weights matter.
"""

from __future__ import annotations

import numpy as np

from latice_tpu_torch.sim.kinematical import Reflectors
from latice_tpu_torch.sim.master import lambert_to_directions

__all__ = ["fit_reflectors_to_master", "kinematical_master_ncc"]


def _master_grid_directions(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Directions + validity mask for `sim.master`'s equal-area circle
    layout (same grid `dynamical_master_pattern` renders on)."""
    half = (size - 1) / 2.0
    ij = (np.arange(size, dtype=np.float64) - half) / half  # [-1, 1]
    x, y = np.meshgrid(ij, -ij, indexing="xy")
    xy = np.stack([x, y], axis=-1) * np.sqrt(2.0)
    valid = (xy**2).sum(axis=-1) <= 2.0 + 1e-9  # inside the equator circle
    return lambert_to_directions(xy), valid


def _profile_matrix(
    dirs: np.ndarray, reflectors: Reflectors, edge_frac: float
) -> np.ndarray:
    """(P, K) band-profile basis — the SAME profile `sim.refine` renders
    (refine.py `_simulate_flat`), so the fitted weights transfer exactly."""
    sines = np.abs(dirs @ reflectors.normals.astype(np.float64).T)
    half = reflectors.sin_theta.astype(np.float64)[None, :]
    soft = np.maximum(half * edge_frac, 1e-6)
    z = (half - sines) / soft
    # Numerically-stable sigmoid.
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def fit_reflectors_to_master(
    master_img: np.ndarray,
    candidates: Reflectors,
    edge_frac: float = 0.25,
    max_bands: int = 256,
    ridge: float = 1e-4,
    clip_rounds: int = 3,
    allow_negative: bool = True,
) -> tuple[Reflectors, float]:
    """Fit per-band weights of the differentiable profile model to a master.

    Args:
        master_img: ``(size, size)`` master in `sim.master`'s equal-area
            circle convention (import square-Lambert masters through
            `resample_square_lambert` first).
        candidates: band geometry (normals + Bragg sines) of the phase —
            use the Bravais-sublattice reflector table (module docstring);
            candidate intensities are ignored, the fit replaces them.
        edge_frac: profile softness — MUST match the ``edge_frac`` the
            refinement will run with (`sim.refine` default 0.25).
        max_bands: keep at most this many strongest fitted bands.
        ridge: Tikhonov weight on the normal equations (relative to the
            mean diagonal) — stabilizes near-collinear candidate profiles.
        clip_rounds: negative-weight clip + active-set re-solve passes
            (only used when ``allow_negative=False``).
        allow_negative: keep signed band weights (default — deficit bands
            are real dynamical features and NCC refinement is
            affine-invariant); False forces a non-negative fit.

    Returns:
        ``(fitted Reflectors, fit_ncc)`` — ``fit_ncc`` is the normalized
        cross-correlation between the fitted band render and the master
        over valid pixels (≥0.9 means the band model explains the master
        well enough for NCC refinement to be trustworthy).
    """
    img = np.asarray(master_img, np.float64)
    if img.ndim != 2 or img.shape[0] != img.shape[1]:
        raise ValueError(f"master must be square (size, size), got {img.shape}")
    if len(candidates) == 0:
        raise ValueError("candidate reflector table is empty")
    dirs, valid = _master_grid_directions(img.shape[0])
    d = dirs[valid]
    y = img[valid]
    phi = _profile_matrix(d, candidates, edge_frac)  # (P, K)

    # Centered ridge LSQ (the intercept absorbs the master's background).
    y0 = y - y.mean()
    mu = phi.mean(axis=0)
    a = phi - mu
    gram = a.T @ a
    lam = ridge * float(np.trace(gram)) / len(gram)
    rhs = a.T @ y0
    if allow_negative:
        w = np.linalg.solve(gram + lam * np.eye(len(gram)), rhs)
    else:
        active = np.ones(len(gram), bool)
        w = np.zeros(len(gram))
        for _ in range(max(clip_rounds, 1)):
            idx = np.flatnonzero(active)
            g = gram[np.ix_(idx, idx)] + lam * np.eye(len(idx))
            w_act = np.linalg.solve(g, rhs[idx])
            w = np.zeros(len(gram))
            w[idx] = w_act
            neg = w < 0
            if not neg.any():
                break
            active &= ~neg
            if not active.any():
                raise ValueError(
                    "band fit degenerated: every candidate weight clipped "
                    "to zero — wrong candidate geometry for this master?"
                )
        w = np.maximum(w, 0.0)
    if np.abs(w).max() <= 0:
        raise ValueError(
            "band fit found no nonzero weights — the candidate table does "
            "not match this master's band geometry"
        )

    # Fit quality on the FULL candidate render (before truncation).
    pred = phi @ w
    pred0 = pred - pred.mean()
    ncc = float(
        (pred0 @ y0)
        / (np.linalg.norm(pred0) * np.linalg.norm(y0) + 1e-12)
    )

    order = np.argsort(-np.abs(w))
    keep = order[: min(max_bands, int((np.abs(w) > 0).sum()))]
    keep = keep[np.abs(w[keep]) > 0]
    w_kept = w[keep] / np.abs(w[keep]).max()
    fitted = Reflectors(
        normals=candidates.normals[keep].astype(np.float32),
        sin_theta=candidates.sin_theta[keep].astype(np.float32),
        intensity=w_kept.astype(np.float32),
    )
    return fitted, ncc


def kinematical_master_ncc(
    master_img: np.ndarray, reflectors: Reflectors, edge_frac: float = 0.25
) -> float:
    """NCC between a band-model render and a master image over valid
    pixels — the fit-quality metric of `fit_reflectors_to_master`, usable
    standalone to check any reflector table against any master."""
    img = np.asarray(master_img, np.float64)
    dirs, valid = _master_grid_directions(img.shape[0])
    phi = _profile_matrix(dirs[valid], reflectors, edge_frac)
    pred = phi @ reflectors.intensity.astype(np.float64)
    y0 = img[valid] - img[valid].mean()
    p0 = pred - pred.mean()
    return float(
        (p0 @ y0) / (np.linalg.norm(p0) * np.linalg.norm(y0) + 1e-12)
    )
