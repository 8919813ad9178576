"""The comparisons that decide ``correct`` in the index cells: what the
timed path returned, held against the plain reference recomputed from the
benchmark's own weights, dictionary and patterns.

Each stage of the pipeline is judged by itself, from the input the timed
path handed it (`candidate_numbers`):

* encoder: ``latent_gap_vs_bf16``. Per row, the latent gap is the
  distance between the unit latent the search received (``mu``, kept from
  the window) and the reference's unit latent of the same uint8 pattern;
  it bounds how far any cosine score of the row can move. The number is
  the 90th percentile of the program's gaps over that of the reference's
  own run with every operand rounded to bfloat16, on the same weights and
  patterns. Random weights make the encoder chaotic, and how much so
  varies from seed to seed by 1.7x, more than the float8 control's margin
  over bfloat16 allows; over its own bfloat16 run the seed's sensitivity
  cancels (PERF.md). The 90th percentile, so that a fault in a tenth of
  the rows shows.
* search (K1), from the program's own latents: ``search_score_gap``, the
  widest gap between a returned score and the reference's f32 cosine of
  the same latent and dictionary row; ``topk_miss``, an exact count of the
  rows whose candidates repeat a row or leave out a dictionary row that
  scores more than ``TIE`` above the lowest candidate;
* consensus, over the returned candidates: ``consensus_mismatch``, rows
  whose success, count of similar candidates or phase differ from the
  reference consensus; ``orientation_gap_deg``, the widest angle between a
  returned orientation (best, and mean where it succeeded) and the
  reference consensus's.

`control_outputs` is the reference put in the program's place in the
nearest precision below the configuration's: every operand of every
convolution and product, the search's included, rounded to float8 e4m3
(for the encoder's bfloat16), and the consensus in bfloat16 (for its
float32).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import rotations as rot
from port_bench.reference import vae as ref
from port_bench.reference.consensus import consensus
from port_bench.reference.search import cosine_scores, normalize

__all__ = ["Dictionary", "TIE", "candidate_numbers", "control_outputs", "encode", "program_quats"]

# A dictionary row that the search left out may score this much above the
# lowest candidate: f32 cosines of unit vectors of 64 terms or fewer,
# summed in another order, differ by about 1e-7.
TIE = 1e-5

COMPARED = ("latent_gap_vs_bf16", "search_score_gap", "topk_miss", "consensus_mismatch",
            "orientation_gap_deg")


def _same(x):
    return x


@torch.no_grad()
def encode(params: dict, cfg: dict, patterns: np.ndarray, device, cast=_same, rows: int = 128):
    """Reference ``mu`` of uint8 ``(n, S, S)`` patterns, ``(n, D)`` f32."""
    out = []
    with ref.full_f32():
        for i in range(0, len(patterns), rows):
            x = torch.as_tensor(patterns[i : i + rows], device=device).float()[:, None] / 255.0
            out.append(ref.encode(params, cfg, x, cast)[0])
    return torch.cat(out)


class Dictionary:
    """The reference's view of the dictionary the benchmark made."""

    def __init__(self, vectors: np.ndarray, euler: np.ndarray, phases: np.ndarray | None,
                 groups: list[str], device) -> None:
        self.vectors = normalize(torch.as_tensor(vectors, device=device))
        self.quats = rot.from_euler_zxz_deg(euler)
        self.phases = phases
        self.groups = groups

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


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 and back."""
    return torch.as_tensor(np.asarray(x)).to(torch.bfloat16).double().numpy()


def _angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.rad2deg(rot.misorientation(a, b))


def _worst(x) -> float:
    """The largest of ``x``, a NaN counting as infinite."""
    return float(np.nan_to_num(np.asarray(x, np.float64), nan=np.inf).max(initial=0.0))


def _latent_gaps(mu: torch.Tensor, ref_mu: torch.Tensor) -> np.ndarray:
    """Per row, the distance between the unit latents (a NaN as infinite)."""
    gap = torch.linalg.vector_norm(normalize(mu) - normalize(ref_mu), dim=-1).cpu().numpy()
    return np.nan_to_num(gap, nan=np.inf)


def _search(latents: torch.Tensor, dic: Dictionary, idx: np.ndarray, scores: np.ndarray,
            rows: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Per row, the widest gap between a returned score and the reference
    cosine of the same row, and by how much the best dictionary row left
    out scores above the lowest candidate (``inf`` where a row repeats)."""
    gaps, excess = [], []
    for i in range(0, len(latents), rows):
        s = cosine_scores(latents[i : i + rows], dic.vectors)
        at_idx = torch.as_tensor(idx[i : i + rows], device=s.device)
        at = torch.gather(s, 1, at_idx)
        got = torch.as_tensor(np.asarray(scores[i : i + rows]), device=s.device).float()
        gaps.append((got - at).abs().max(1).values.cpu().numpy())
        left_out = s.scatter(1, at_idx, -torch.inf).max(1).values
        ex = (left_out - at.min(1).values).cpu().numpy()
        srt = np.sort(idx[i : i + rows], axis=1)
        ex[(srt[:, 1:] == srt[:, :-1]).any(1)] = np.inf
        excess.append(ex)
    return np.concatenate(gaps), np.concatenate(excess)


def candidate_numbers(cfg: dict, params: dict, dic: Dictionary, patterns: np.ndarray,
                      out: dict, device, detail: bool = False) -> dict:
    """The index cells' numbers for program outputs ``out``: ``latents``
    (n, D) as the search received them, ``scores``, ``indices`` (n, K),
    ``success``, ``n_similar``, ``best_q``, ``mean_q`` (n, 4) and ``phase``
    (or None); ``detail`` adds statistics that are not compared."""
    idx = np.asarray(out["indices"])
    if idx.min() < 0 or idx.max() >= len(dic.vectors):
        return dict.fromkeys(COMPARED, float("inf"))
    ref_mu = encode(params, cfg, patterns, device)
    mu = torch.as_tensor(np.asarray(out["latents"]), device=ref_mu.device).float()
    lat = _latent_gaps(mu, ref_mu)
    own = _latent_gaps(encode(params, cfg, patterns, device, cast=ref.bf16), ref_mu)
    score_gap, excess = _search(mu, dic, idx, out["scores"])
    cons = dic.consensus(idx, cfg)
    diff = (np.asarray(out["success"]) != cons.success) | (np.asarray(out["n_similar"]) != cons.n_similar)
    if cons.phase is not None:
        diff |= np.asarray(out["phase"]) != cons.phase
    gap = _angle_deg(out["best_q"], cons.best)
    ok = cons.success & np.asarray(out["success"])
    mean_gap = _angle_deg(out["mean_q"][ok], cons.mean[ok])
    numbers = {
        "latent_gap_vs_bf16": float(np.percentile(lat, 90) / np.percentile(own, 90)),
        "search_score_gap": _worst(score_gap),
        "topk_miss": float((np.nan_to_num(excess, nan=np.inf) > TIE).sum()),
        "consensus_mismatch": float(diff.sum()),
        "orientation_gap_deg": _worst(np.concatenate([gap, mean_gap])),
    }
    if detail:
        numbers.update({f"latent_gap_q{q}": float(np.percentile(lat, q)) for q in (50, 90, 99)})
        numbers["latent_gap_max"] = _worst(lat)
        numbers["bf16_gap_q90"] = float(np.percentile(own, 90))
        numbers["topk_excess_max"] = _worst(excess)
        end_to_end, _ = _search(ref_mu, dic, idx, out["scores"])
        numbers["score_gap"] = _worst(end_to_end)
    return numbers


def control_outputs(cfg: dict, params: dict, dic: Dictionary, patterns: np.ndarray, device) -> dict:
    """What the reference one precision below the configuration's returns in
    the program's place, in the shape `candidate_numbers` reads: the encoder
    and the search's product in float8, the consensus in bfloat16."""
    mu = encode(params, cfg, patterns, device, cast=ref.fp8)
    scores = cosine_scores(ref.fp8(normalize(mu)), ref.fp8(dic.vectors))
    top = torch.topk(scores, cfg["top_n"], dim=1)
    idx = top.indices.cpu().numpy()
    cons = dic.consensus(idx, cfg, rounding=bf16)
    return {"latents": mu.cpu().numpy(), "scores": top.values.cpu().numpy(), "indices": idx,
            "success": cons.success, "n_similar": cons.n_similar, "best_q": cons.best,
            "mean_q": cons.mean, "phase": cons.phase}


def program_quats(best_euler: np.ndarray, mean_euler: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The program's zxz degrees as quaternions (a NaN mean stays NaN)."""
    return rot.from_euler_zxz_deg(best_euler), rot.from_euler_zxz_deg(mean_euler)
