"""Batched orientation consensus over the top-K candidates of each query.

The reference's iterate-until-enough-matches loop (faiss_db.py:258-372) as
fixed-shape tensor code over a whole batch, as in
``latice_tpu.index.consensus``:

1. each of the first ``max_iterations`` candidates is tried as reference,
   and the misorientation of every candidate to it is measured;
2. a trial succeeds when at least ``min_required_matches`` candidates lie
   within ``orientation_threshold``; the first succeeding trial is chosen,
   else the last one (whose mask is reported, as the reference loop
   leaves it);
3. every candidate is snapped to its symmetry equivalent nearest the chosen
   reference, and the in-threshold ones are averaged.

``angle_unit`` is "deg" (FAISS semantics) or "rad" (the chroma backend's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from latice_tpu_torch.crystal import (
    from_euler_zxz_deg,
    misorientation_angle,
    nearest_symmetry_equivalent,
    quat_mean,
    symmetry_quats,
    to_euler_zxz_deg,
)

__all__ = ["ConsensusOutput", "consensus_orientations", "consensus_from_euler"]

_DEG = 180.0 / torch.pi


class ConsensusOutput(NamedTuple):
    """Batch consensus results, leading dimension B.

    Attributes:
        mean_euler: ``(B, 3)`` mean orientation, zxz degrees (valid where
            ``success``).
        success: ``(B,)`` bool.
        similar_mask: ``(B, K)`` bool, candidates within threshold of the
            chosen reference (the last tried one on failure).
        chosen_iter: ``(B,)`` int, the succeeding trial (0 on failure).
        misorientation_deg: ``(B, K)`` misorientation to the chosen reference.
        phase: ``(B,)`` int phase of the chosen reference, or None.
    """

    mean_euler: torch.Tensor
    success: torch.Tensor
    similar_mask: torch.Tensor
    chosen_iter: torch.Tensor
    misorientation_deg: torch.Tensor
    phase: torch.Tensor | None = None


def consensus_orientations(
    cand_quats: torch.Tensor,
    orientation_threshold: float,
    min_required_matches: int = 18,
    max_iterations: int = 3,
    angle_unit: str = "deg",
    cand_phases: torch.Tensor | None = None,
    sym_tables: torch.Tensor | None = None,
    cand_weights: torch.Tensor | None = None,
) -> ConsensusOutput:
    """Consensus of ``(B, K, 4)`` best-first candidate quaternions.

    Args:
        cand_quats: scalar-first unit quaternions of the top-K candidates.
        orientation_threshold: misorientation threshold in ``angle_unit``.
        min_required_matches: in-threshold candidates needed for success.
        max_iterations: leading candidates tried as reference (clamped to K).
        angle_unit: "deg" or "rad".
        cand_phases: optional ``(B, K)`` int phase per candidate; candidates
            of another phase than the trial reference never count, and the
            snap uses the chosen reference's phase group.
        sym_tables: optional ``(P, S, 4)`` per-phase symmetry tables
            (`crystal.stack_symmetry_tables`); cubic when omitted.
        cand_weights: optional ``(B, K)`` nonnegative weights for a weighted
            mean over the in-threshold candidates, renormalized by their
            row maximum (rows whose masked weights are all zero fall back to
            the uniform mean).
    """
    if angle_unit not in ("deg", "rad"):
        raise ValueError(f"angle_unit must be 'deg' or 'rad', got {angle_unit!r}")
    b, k, _ = cand_quats.shape
    iters = min(max_iterations, k)
    dtype, device = cand_quats.dtype, cand_quats.device

    refs = cand_quats[:, :iters, :]
    mis_rad = misorientation_angle(refs[:, :, None, :], cand_quats[:, None, :, :])
    mis_cmp = mis_rad * _DEG if angle_unit == "deg" else mis_rad

    within = mis_cmp < orientation_threshold  # (B, I, K)
    if cand_phases is not None:
        ref_phases = cand_phases[:, :iters]
        within = within & (ref_phases[:, :, None] == cand_phases[:, None, :])
    ok = within.sum(dim=-1) >= min_required_matches  # (B, I)

    success = ok.any(dim=-1)
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)  # first True, else 0
    chosen = torch.where(success, first_ok, torch.full_like(first_ok, iters - 1))

    sel = chosen[:, None]
    similar_mask = torch.gather(within, 1, sel[..., None].expand(b, 1, k))[:, 0]
    mis_chosen_rad = torch.gather(mis_rad, 1, sel[..., None].expand(b, 1, k))[:, 0]
    ref_chosen = torch.gather(refs, 1, sel[..., None].expand(b, 1, 4))[:, 0]

    phase = None
    if cand_phases is not None:
        phase = torch.gather(ref_phases, 1, sel)[:, 0]
        if sym_tables is None:
            sym = symmetry_quats("432", dtype=dtype, device=device)
        else:
            sym = sym_tables.to(dtype=dtype, device=device)[phase.long()][:, None]
    else:
        sym = symmetry_quats("432", dtype=dtype, device=device)
    sym_eq = nearest_symmetry_equivalent(ref_chosen[:, None, :], cand_quats, sym)

    mean_w = similar_mask.to(dtype)
    if cand_weights is not None:
        w = mean_w * cand_weights.to(dtype)
        wmax = w.max(dim=-1, keepdim=True).values
        w_norm = w / torch.where(wmax > 0, wmax, torch.ones_like(wmax))
        mean_w = torch.where(wmax > 0, w_norm, mean_w)
    mean_quat = quat_mean(sym_eq, mean_w)

    return ConsensusOutput(
        mean_euler=to_euler_zxz_deg(mean_quat),
        success=success,
        similar_mask=similar_mask,
        chosen_iter=torch.where(success, first_ok, torch.zeros_like(first_ok)),
        misorientation_deg=mis_chosen_rad * _DEG,
        phase=phase,
    )


def consensus_from_euler(
    cand_euler_deg: torch.Tensor,
    orientation_threshold: float,
    min_required_matches: int = 18,
    max_iterations: int = 3,
    angle_unit: str = "deg",
) -> ConsensusOutput:
    """`consensus_orientations` of ``(B, K, 3)`` zxz Euler degrees, on
    their device."""
    return consensus_orientations(
        from_euler_zxz_deg(cand_euler_deg),
        orientation_threshold,
        min_required_matches=min_required_matches,
        max_iterations=max_iterations,
        angle_unit=angle_unit,
    )
