"""The consensus of a batch's top-k candidates: a CUDA kernel (K4) and its
plain twin.

Replaces no TPU kernel: the JAX package's consensus is plain jnp that XLA
fuses under ``jit``. The kernel is ``csrc/consensus_fused.cu``; its source
note says what bounds it on the card (launch latency) and how it is laid
out. It does in one launch, with no host sync, what the eager consensus did
in several hundred.

Contract, that of `index.pipeline.CandidateConsensus`: from a batch's
best-first ``(B, k)`` f32 scores and integer dictionary rows, the
dictionary's ``(N, 4)`` unit quaternions (``(N, 5)`` with the phase id as a
fifth column) and the ``(P, S, 4)`` per-phase symmetry tables, a
`ConsensusResult`: `index.consensus.consensus_orientations`' trials, snap
and chordal mean, with the in-threshold candidates weighted by ``(s /
s_max) ** weight_power`` when that is given, the chosen trial's
per-candidate mask, and the top-1 candidate as the best orientation where
no trial succeeds.

`candidate_consensus_fused` launches the kernel on CUDA tensors and runs
the plain version `candidate_consensus_fused_plain` on CPU tensors; nothing
falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from latice_tpu_torch.ops import _build

__all__ = ["ConsensusResult", "candidate_consensus_fused", "candidate_consensus_fused_plain"]


class ConsensusResult(NamedTuple):
    """One batch's consensus, on the batch's device."""

    mean_euler: torch.Tensor  # (B, 3) f32 zxz degrees, whether or not a trial succeeds
    best: torch.Tensor  # (B, 3) f32: the mean, or the top-1 candidate where none succeeds
    success: torch.Tensor  # (B,) bool
    n_similar: torch.Tensor  # (B,) int64: the chosen trial's matches
    similar_mask: torch.Tensor  # (B, k) bool: which candidates they are
    indices: torch.Tensor  # the (B, k) input rows, returned as given
    scores: torch.Tensor  # the (B, k) input scores, returned as given
    phase: torch.Tensor | None = None  # (B,) int32 with phases: the top-1's where none succeeds


def _check(scores, indices, rows, sym_tables, max_iterations: int, angle_unit: str) -> None:
    if angle_unit not in ("deg", "rad"):
        raise ValueError(f"angle_unit must be 'deg' or 'rad', got {angle_unit!r}")
    if scores.dim() != 2 or indices.shape != scores.shape or scores.shape[1] < 1:
        raise ValueError(
            "the consensus takes (B, k) scores and indices with k >= 1, got "
            f"{tuple(scores.shape)} and {tuple(indices.shape)}"
        )
    if indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"indices must be int32 or int64, got {indices.dtype}")
    if rows.dim() != 2 or rows.shape[1] not in (4, 5) or rows.dtype != torch.float32:
        raise ValueError(
            f"rows must be (N, 4) or (N, 5) float32, got {tuple(rows.shape)} {rows.dtype}"
        )
    if sym_tables.dim() != 3 or sym_tables.shape[2] != 4 or min(sym_tables.shape) < 1:
        raise ValueError(f"sym_tables must be (P, S, 4), got {tuple(sym_tables.shape)}")
    if max_iterations < 1:
        raise ValueError(f"max_iterations must be at least 1, got {max_iterations}")


def candidate_consensus_fused_plain(
    scores: torch.Tensor,
    indices: torch.Tensor,
    rows: torch.Tensor,
    sym_tables: torch.Tensor,
    orientation_threshold: float,
    min_required_matches: int,
    max_iterations: int,
    angle_unit: str = "deg",
    weight_power: float | None = None,
) -> ConsensusResult:
    """The same function in plain torch, on the tensors' device: the rows
    gathered, `index.consensus.consensus_orientations`, the Euler angles
    and the top-1 fallback."""
    from latice_tpu_torch.crystal import to_euler_zxz_deg
    from latice_tpu_torch.index.consensus import consensus_orientations

    _check(scores, indices, rows, sym_tables, max_iterations, angle_unit)
    cand_rows = rows[indices]
    cand_quats = cand_rows[..., :4]
    cand_phases = None if rows.shape[1] == 4 else cand_rows[..., 4].to(torch.int32)
    cand_weights = None
    if weight_power is not None:
        # Normalize by the row max before powering: raw s**p flushes to
        # zero in f32 for p=256 at s below ~0.71.
        pos = torch.clamp(scores, min=0.0)
        top = torch.clamp(pos.max(dim=-1, keepdim=True).values, min=1e-30)
        cand_weights = (pos / top) ** weight_power
    cons = consensus_orientations(
        cand_quats,
        orientation_threshold,
        min_required_matches=min_required_matches,
        max_iterations=max_iterations,
        angle_unit=angle_unit,
        cand_phases=cand_phases,
        sym_tables=sym_tables,
        cand_weights=cand_weights,
    )
    # Failure fallback: the top-1 candidate, in canonical scipy ranges.
    top1_euler = to_euler_zxz_deg(cand_quats[:, 0])
    best = torch.where(cons.success[:, None], cons.mean_euler, top1_euler)
    phase = None
    if cand_phases is not None:
        phase = torch.where(cons.success, cons.phase, cand_phases[:, 0])
    return ConsensusResult(cons.mean_euler, best, cons.success, cons.similar_mask.sum(dim=1),
                           cons.similar_mask, indices, scores, phase)


def candidate_consensus_fused(
    scores: torch.Tensor,
    indices: torch.Tensor,
    rows: torch.Tensor,
    sym_tables: torch.Tensor,
    orientation_threshold: float,
    min_required_matches: int,
    max_iterations: int,
    angle_unit: str = "deg",
    weight_power: float | None = None,
) -> ConsensusResult:
    """The consensus of ``(B, k)`` candidates in one launch.

    On CUDA tensors this launches ``csrc/consensus_fused.cu`` and adds one
    to ``candidate_consensus_fused.launches``; on CPU tensors it runs
    `candidate_consensus_fused_plain`. ``max_iterations`` is clamped to k.
    A row index outside the dictionary gives NaN orientations and no
    success on the card (the plain version raises).
    """
    devices = {t.device for t in (scores, indices, rows, sym_tables)}
    if devices == {torch.device("cpu")}:
        return candidate_consensus_fused_plain(
            scores, indices, rows, sym_tables, orientation_threshold, min_required_matches,
            max_iterations, angle_unit, weight_power,
        )
    _check(scores, indices, rows, sym_tables, max_iterations, angle_unit)
    dev = scores.device
    if dev.type != "cuda" or len(devices) != 1:
        raise ValueError(
            "candidate_consensus_fused takes its tensors on one CUDA device, got "
            f"{sorted(str(d) for d in devices)}"
        )
    if scores.dtype != torch.float32 or sym_tables.dtype != torch.float32:
        raise ValueError(
            f"candidate_consensus_fused takes float32 scores and tables, got {scores.dtype} "
            f"and {sym_tables.dtype}"
        )
    n_phases, n_sym, _ = sym_tables.shape
    b, k = scores.shape
    phased = rows.shape[1] == 5
    mean = torch.empty((b, 3), dtype=torch.float32, device=dev)
    best = torch.empty((b, 3), dtype=torch.float32, device=dev)
    success = torch.empty((b,), dtype=torch.bool, device=dev)
    n_similar = torch.empty((b,), dtype=torch.int64, device=dev)
    mask = torch.empty((b, k), dtype=torch.bool, device=dev)
    phase = torch.empty((b,), dtype=torch.int32, device=dev) if phased else None
    if b:
        s, i = scores.contiguous(), indices.contiguous()
        r, t = rows.contiguous(), sym_tables.contiguous()
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.latice_candidate_consensus_fused(
                s.data_ptr(), i.data_ptr(), int(i.dtype == torch.int64), r.data_ptr(),
                r.shape[0], r.shape[1], t.data_ptr(), n_phases, n_sym, b, k,
                min(max_iterations, k), min_required_matches, orientation_threshold,
                int(angle_unit == "deg"), int(weight_power is not None),
                0.0 if weight_power is None else weight_power,
                mean.data_ptr(), best.data_ptr(), success.data_ptr(), n_similar.data_ptr(),
                mask.data_ptr(), None if phase is None else phase.data_ptr(), stream,
            )
        # The library refuses tables beyond a block's shared memory.
        _build.check(lib, code, f"candidate_consensus_fused of {n_phases} x {n_sym} symmetry "
                                "operators")
        candidate_consensus_fused.launches += 1
    return ConsensusResult(mean, best, success, n_similar, mask, indices, scores, phase)


candidate_consensus_fused.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("consensus_fused")
    fn = lib.latice_candidate_consensus_fused
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, p, i, i, p, i, i, i, i, i, i, f, i, i, f, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib
