"""The comparisons that decide ``correct`` in the pattern DI cells: what the
timed path returned, held against the plain reference (``reference/ncc.py``
and ``reference/consensus.py``) recomputed from the benchmark's own
dictionary and scan.

Each stage is judged by itself, from the input the timed path handed it
(`numbers`):

* features (NCC): ``feature_gap``, the widest distance between a row's
  features as the search received them and the reference's features of
  the same uint8 pattern. Both are unit rows; f32 sums of 16,384 pixels
  in two orders differ by ~1e-7, a bfloat16 rounding by ~2e-3.
* search (K5, or the exact engine), from the program's own features:
  ``search_score_gap``, the widest gap between a returned score and the
  reference's score of the same features and dictionary row at the
  configuration's precision (both operands in bfloat16, products and sums
  in f32); ``topk_miss``, an exact count of the rows whose candidates
  repeat a row or leave out a dictionary row that scores more than `TIE`
  above the lowest candidate;
* consensus, over the returned candidates: ``consensus_mismatch`` and
  ``orientation_gap_deg``, as in `check.candidate_numbers`.

`control_outputs` is the reference one precision below the
configuration's in the program's place: the features rounded to bfloat16,
the search's operands to float8 e4m3 (for bfloat16), the consensus in
bfloat16 (for float32).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.check import _angle_deg, _worst, bf16
from port_bench.reference import ncc
from port_bench.reference import rotations as rot
from port_bench.reference.consensus import consensus
from port_bench.reference.vae import fp8

__all__ = ["COMPARED", "Dictionary", "TIE", "bf16_sum_scores", "control_outputs", "numbers", "outputs",
           "planted_outputs", "reference_scores"]

# A dictionary row that the search left out may score this much above the
# lowest candidate: the tensor cores' f32 sums of 16,384 bf16 products
# drift up to ~1e-4 from cuBLAS's near a score of 1, twice that for a pair
# of scores; a score rounded to bfloat16 moves up to 2e-3 (PERF.md §2).
TIE = 2e-4

COMPARED = ("feature_gap", "search_score_gap", "topk_miss", "consensus_mismatch",
            "orientation_gap_deg")


class Dictionary:
    """The reference's view of the DI dictionary: the host uint8 patterns,
    whose NCC rows are computed in blocks on ``device``, and the rows'
    orientations."""

    def __init__(self, patterns: np.ndarray, euler: np.ndarray, phases: np.ndarray | None,
                 groups: list[str], bin_factor: int, device, block: int = 16384) -> None:
        self.patterns = patterns
        self.quats = rot.from_euler_zxz_deg(euler)
        self.phases = phases
        self.groups = groups
        self.bin_factor = bin_factor
        self.device = device
        self.block = block

    def __len__(self) -> int:
        return len(self.patterns)

    def blocks(self):
        """``(start, (n, D) f32 unit rows)`` of the reference's features."""
        for start in range(0, len(self.patterns), self.block):
            part = torch.as_tensor(np.ascontiguousarray(self.patterns[start : start + self.block]),
                                   device=self.device)
            yield start, ncc.features(part, self.bin_factor)

    def consensus(self, idx: np.ndarray, cfg: dict, rounding=None):
        """The reference consensus over candidate rows ``idx``; ``rounding``
        (the control's) rounds the candidates and the results."""
        ph = None if self.phases is None else self.phases[idx]
        q = self.quats[idx] if rounding is None else rounding(self.quats[idx])
        out = consensus(q, cfg["threshold_deg"], cfg["min_matches"], cfg["max_iterations"], ph,
                        self.groups)
        if rounding is not None:
            out = out._replace(best=rounding(out.best), mean=rounding(out.mean))
        return out


def reference_scores(queries: torch.Tensor, dic: Dictionary, score=None) -> torch.Tensor:
    """``(B, N)`` f32 scores of the query rows against every dictionary row,
    block by block: ``score(queries, table_block)`` (by default the
    reference's search at the configuration's precision, bfloat16)."""
    score = score or (lambda q, t: ncc.scores(q, t, "bfloat16"))
    out = torch.empty((len(queries), len(dic)), dtype=torch.float32, device=queries.device)
    for start, table in dic.blocks():
        out[:, start : start + len(table)] = score(queries, table)
    return out


def bf16_sum_scores(queries: torch.Tensor, table: torch.Tensor, step: int = 64) -> torch.Tensor:
    """A planted fault: the bfloat16 search with its running sums rounded
    to bfloat16 after every ``step`` features."""
    q, t = ncc.bf16(ncc.normalize(queries)), ncc.bf16(table)
    acc = torch.zeros((len(q), len(t)), dtype=torch.bfloat16, device=q.device)
    with ncc.full_f32():
        for j in range(0, q.shape[1], step):
            acc = (acc.float() + q[:, j : j + step] @ t[:, j : j + step].T).bfloat16()
    return acc.float()


def _search(s: torch.Tensor, idx: np.ndarray, scores: np.ndarray,
            rows: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Per row of the reference scores ``s``: the widest gap between a
    returned score and the reference's at the same row, and by how much the
    best dictionary row left out scores above the lowest candidate
    (``inf`` where a row repeats)."""
    gaps, excess = [], []
    for i in range(0, len(s), rows):
        blk = s[i : i + rows]
        at_idx = torch.as_tensor(idx[i : i + rows], device=s.device)
        at = torch.gather(blk, 1, at_idx)
        got = torch.as_tensor(np.asarray(scores[i : i + rows]), device=s.device).float()
        gaps.append((got - at).abs().max(1).values.cpu().numpy())
        left_out = blk.scatter(1, at_idx, -torch.inf).max(1).values
        ex = (left_out - at.min(1).values).cpu().numpy()
        srt = np.sort(idx[i : i + rows], axis=1)
        ex[(srt[:, 1:] == srt[:, :-1]).any(1)] = np.inf
        excess.append(ex)
    return np.concatenate(gaps), np.concatenate(excess)


def numbers(cfg: dict, dic: Dictionary, patterns: np.ndarray, out: dict, device,
            detail: bool = False) -> dict:
    """The DI cells' numbers for program outputs ``out``: ``features``
    (n, D) as the search received them, ``scores``, ``indices`` (n, K),
    ``success``, ``n_similar``, ``best_q``, ``mean_q`` (n, 4) and ``phase``
    (or None), for the uint8 ``patterns`` (n, S, S); ``detail`` adds
    statistics that are not compared."""
    idx = np.asarray(out["indices"])
    if idx.min() < 0 or idx.max() >= len(dic):
        return dict.fromkeys(COMPARED, float("inf"))
    ref_f = ncc.features(torch.as_tensor(patterns, device=device), cfg["bin_factor"])
    f = torch.as_tensor(np.asarray(out["features"]), device=device).float()
    gap = torch.linalg.vector_norm(f - ref_f, dim=1).cpu().numpy()
    s = reference_scores(f, dic, lambda q, t: ncc.scores(q, t, cfg["search_dtype"]))
    score_gap, excess = _search(s, idx, out["scores"])
    del s
    cons = dic.consensus(idx, cfg)
    diff = (np.asarray(out["success"]) != cons.success) | (np.asarray(out["n_similar"]) != cons.n_similar)
    if cons.phase is not None:
        diff |= np.asarray(out["phase"]) != cons.phase
    best_gap = _angle_deg(out["best_q"], cons.best)
    ok = cons.success & np.asarray(out["success"])
    mean_gap = _angle_deg(out["mean_q"][ok], cons.mean[ok])
    result = {
        "feature_gap": _worst(gap),
        "search_score_gap": _worst(score_gap),
        "topk_miss": float((np.nan_to_num(excess, nan=np.inf) > TIE).sum()),
        "consensus_mismatch": float(diff.sum()),
        "orientation_gap_deg": _worst(np.concatenate([best_gap, mean_gap])),
    }
    if detail:
        result.update({f"feature_gap_q{q}": float(np.percentile(gap, q)) for q in (50, 90, 99)})
        result["topk_excess_max"] = _worst(excess)
        result["score_gap_q99"] = float(np.percentile(score_gap, 99))
        result["success_share"] = float(np.mean(out["success"]))
    return result


def outputs(cfg: dict, dic: Dictionary, f: torch.Tensor, s: torch.Tensor, rounding=None) -> dict:
    """Program-shaped outputs of features ``f`` and scores ``s`` (n, N):
    the exact top-k, then the reference consensus (rounded by
    ``rounding``)."""
    top_v, top_i = ncc.topk(s, cfg["top_n"])
    idx = top_i.cpu().numpy()
    cons = dic.consensus(idx, cfg, rounding=rounding)
    return {"features": f.cpu().numpy(), "scores": top_v.cpu().numpy(), "indices": idx,
            "success": cons.success, "n_similar": cons.n_similar, "best_q": cons.best,
            "mean_q": cons.mean, "phase": cons.phase}


def control_outputs(cfg: dict, dic: Dictionary, patterns: np.ndarray, device) -> dict:
    """What the reference one precision below the configuration's returns
    in the program's place: bfloat16 features, the search's operands in
    float8 e4m3, the consensus in bfloat16."""
    f = ncc.bf16(ncc.features(torch.as_tensor(patterns, device=device), cfg["bin_factor"]))

    def fp8_scores(q, t):
        with ncc.full_f32():
            return fp8(ncc.normalize(q)) @ fp8(t).T

    return outputs(cfg, dic, f, reference_scores(f, dic, fp8_scores), rounding=bf16)


def planted_outputs(cfg: dict, dic: Dictionary, features: np.ndarray, device, fault: str) -> dict:
    """The program's features searched by a faulty search in its place:
    ``bf16_sums`` (running sums rounded to bfloat16) or ``bf16_scores``
    (the right sums, each score then rounded to bfloat16); the reference
    consensus over its candidates."""
    f = torch.as_tensor(features, device=device).float()
    if fault == "bf16_sums":
        s = reference_scores(f, dic, bf16_sum_scores)
    elif fault == "bf16_scores":
        s = ncc.bf16(reference_scores(f, dic))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return outputs(cfg, dic, f, s)
