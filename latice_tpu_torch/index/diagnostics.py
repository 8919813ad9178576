"""Indexing diagnostics: candidate ambiguity (pseudo-symmetry) per pattern.

The port of ``latice_tpu.index.diagnostics``. Dictionary indexing fails
quietly where two orientation clusters score almost alike (pseudo-symmetric
variants, overlapping phases, patterns the encoder cannot tell apart): the
top-k list splits and the winner flips from pixel to pixel.
`candidate_ambiguity` finds, for each query of a `DenseIndexResult`, the
best-scored *rival*, a candidate whose disorientation from the top-1
exceeds ``min_separation_deg`` or whose phase differs, and the score gap to
it. It runs on a device, chunk by chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal import (
    from_euler_zxz_deg,
    stack_symmetry_tables,
    symmetry_reduced_misorientation,
)
from latice_tpu_torch.device import resolve_device

__all__ = ["AmbiguityResult", "candidate_ambiguity"]

_DEG = 180.0 / np.pi


class AmbiguityResult(NamedTuple):
    """Per-query ambiguity diagnostic.

    Attributes:
        angle_deg: disorientation (degrees, in the top-1's point group) to
            the best rival; NaN without a rival in the top-k.
        score_gap: ``score[0] - score[rival]``; NaN without a rival.
        has_rival: whether any rival is in the top-k.
    """

    angle_deg: np.ndarray
    score_gap: np.ndarray
    has_rival: np.ndarray

    def ambiguous(self, max_gap: float = 0.02) -> np.ndarray:
        """Mask of queries with a rival within ``max_gap`` of the top score."""
        return self.has_rival & (np.nan_to_num(self.score_gap, nan=np.inf) <= max_gap)


def _rival_chunk(cand_e, scores, tables, cand_phase, min_sep_deg):
    """``(B, K)`` candidates to ``(angle_deg, gap, has)`` of one chunk."""
    b, k = scores.shape
    cand_q = from_euler_zxz_deg(cand_e)  # (B, K, 4)
    top_q = cand_q[:, :1, :]
    top_phase = cand_phase[:, 0]
    # The disorientation under every phase's table, then each query's own.
    dis_all = torch.stack(
        [symmetry_reduced_misorientation(top_q, cand_q, sym=sym) for sym in tables]
    )  # (P, B, K) radians
    rows = torch.arange(b, device=scores.device)
    dis = dis_all[top_phase.long(), rows] * _DEG
    rival = (dis > min_sep_deg) | (cand_phase != top_phase[:, None])
    rival[:, 0] = False  # the top-1 is never its own rival
    has = rival.any(dim=1)
    first = torch.argmax(rival.to(torch.int32), dim=1)  # the first, best-scored rival
    nan = torch.full((b,), float("nan"), device=scores.device)
    angle = torch.where(has, dis[rows, first], nan)
    gap = torch.where(has, scores[:, 0] - scores[rows, first], nan)
    return angle, gap, has


@torch.inference_mode()
def candidate_ambiguity(
    result,
    dictionary_angles: np.ndarray,
    group: str = "432",
    phase_groups: list[str] | None = None,
    dictionary_phases: np.ndarray | None = None,
    min_separation_deg: float = 3.0,
    chunk: int = 8192,
    device: str | torch.device | None = None,
) -> AmbiguityResult:
    """Ambiguity of each query of a `DenseIndexResult`.

    Args:
        result: needs ``indices`` and ``scores``.
        dictionary_angles: ``(N, 3)`` zxz degrees the indices point into.
        group: point group of a single-phase dictionary.
        phase_groups: point group per phase (multi-phase dictionaries).
        dictionary_phases: ``(N,)`` phase id per entry (multi-phase).
        min_separation_deg: disorientation below which two candidates are
            the same solution (grid neighbours), not rivals.
        chunk: queries per device batch.
        device: where it runs; ``cuda`` unless given.

    Returns:
        `AmbiguityResult` of host arrays, one entry per query.
    """
    dev = resolve_device(device)
    idx = np.asarray(result.indices)
    scores = np.asarray(result.scores, np.float32)
    b, k = idx.shape
    if k < 2:
        raise ValueError("ambiguity needs top_n >= 2 candidates")
    cand_e = np.asarray(dictionary_angles, np.float32)[idx]  # (B, K, 3), gathered on the host
    groups = list(phase_groups) if phase_groups else [group]
    tables = stack_symmetry_tables(groups, device=dev)
    if dictionary_phases is not None:
        cand_ph = np.asarray(dictionary_phases, np.int32)[idx]
    else:
        cand_ph = np.zeros((b, k), np.int32)
    out_a = np.empty(b, np.float32)
    out_g = np.empty(b, np.float32)
    out_h = np.empty(b, bool)
    for start in range(0, b, chunk):
        stop = min(start + chunk, b)
        a, g, h = _rival_chunk(
            torch.as_tensor(cand_e[start:stop], device=dev),
            torch.as_tensor(scores[start:stop], device=dev),
            tables,
            torch.as_tensor(cand_ph[start:stop], device=dev),
            float(min_separation_deg),
        )
        out_a[start:stop] = a.cpu().numpy()
        out_g[start:stop] = g.cpu().numpy()
        out_h[start:stop] = h.cpu().numpy()
    return AmbiguityResult(out_a, out_g, out_h)
