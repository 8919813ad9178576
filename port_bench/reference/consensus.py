"""The symmetry-aware consensus over a query's best-first candidates, plain
numpy in float64: a frozen copy of the semantics of the reference's FAISS
backend (faiss_db.py:258-372) as the port computes it per batch.

1. Each of the first ``max_iterations`` candidates is tried as reference;
   a trial succeeds when at least ``min_matches`` candidates of its phase
   lie within ``threshold_deg`` of it (plain misorientation, no symmetry).
2. The first succeeding trial is chosen, else the last one tried.
3. Each candidate is snapped to its symmetry image (``s ⊗ q``) nearest the
   chosen reference, and the in-threshold ones are averaged: the leading
   eigenvector of ``Σ q qᵀ`` (the chordal L2 mean).

The best orientation is that mean on success and the top-1 candidate
otherwise; the phase is the chosen reference's on success and the top-1
candidate's otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from port_bench.reference import rotations as rot

__all__ = ["Consensus", "consensus"]


class Consensus(NamedTuple):
    best: np.ndarray  # (B, 4) unit quaternions
    mean: np.ndarray  # (B, 4); meaningful where success
    success: np.ndarray  # (B,) bool
    n_similar: np.ndarray  # (B,) int
    phase: np.ndarray | None  # (B,) int


def consensus(
    cand: np.ndarray,
    threshold_deg: float,
    min_matches: int,
    max_iterations: int,
    cand_phase: np.ndarray | None = None,
    groups: list[str] | None = None,
) -> Consensus:
    """Consensus of ``(B, K, 4)`` candidate quaternions (best first)."""
    cand = np.asarray(cand, np.float64)
    b, k, _ = cand.shape
    iters = min(max_iterations, k)
    refs = cand[:, :iters]
    mis = rot.misorientation(refs[:, :, None, :], cand[:, None, :, :])  # (B, I, K)
    within = np.rad2deg(mis) < threshold_deg
    if cand_phase is not None:
        within &= cand_phase[:, :iters, None] == cand_phase[:, None, :]
    ok = within.sum(-1) >= min_matches
    success = ok.any(-1)
    chosen = np.where(success, np.argmax(ok, axis=-1), iters - 1)
    rows = np.arange(b)
    similar = within[rows, chosen]
    ref = refs[rows, chosen]
    phase = None
    if cand_phase is None:
        sym = rot.point_group("432")[None].repeat(b, 0)
    else:
        phase = cand_phase[rows, chosen]
        tables = [rot.point_group(g) for g in (groups or ["432"])]
        s_max = max(len(t) for t in tables)
        # Shorter groups repeat their first operator: no nearest image changes.
        padded = np.stack([np.concatenate([t, np.repeat(t[:1], s_max - len(t), 0)]) for t in tables])
        sym = padded[phase]
    images = rot.mul(sym[:, None, :, :], cand[:, :, None, :])  # (B, K, S, 4)
    delta = rot.misorientation(ref[:, None, None, :], images)
    nearest = np.argmin(delta, axis=-1)
    snapped = np.take_along_axis(images, nearest[..., None, None], axis=2)[:, :, 0]
    w = similar.astype(np.float64)
    m = np.einsum("bk,bki,bkj->bij", w, snapped, snapped)
    _, vecs = np.linalg.eigh(m)
    mean = vecs[..., -1]
    mean = np.where(mean[:, :1] < 0, -mean, mean)
    best = np.where(success[:, None], mean, cand[:, 0])
    if phase is not None:
        phase = np.where(success, phase, cand_phase[:, 0])
    return Consensus(best, mean, success, similar.sum(-1), phase)
