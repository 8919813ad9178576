"""Exact cosine k-NN, the ``engine="exact"`` search of the pipeline.

Normalize, ``scores = Q @ Dᵀ`` in full f32, then the first ``k`` of a stable
descending sort, so ties go to the lowest index as with ``lax.top_k``
(``torch.topk`` promises no tie order). The fused engine, whose scores
never reach device memory, is `ops.cosine_topk_fused`.
"""

from __future__ import annotations

import torch

__all__ = ["l2_normalize", "cosine_topk"]


def l2_normalize(vectors: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Row-wise L2 normalization; zero rows stay zero instead of NaN."""
    norms = torch.linalg.vector_norm(vectors, dim=dim, keepdim=True)
    return vectors / torch.where(norms == 0, torch.ones_like(norms), norms)


def cosine_topk(
    queries: torch.Tensor, dictionary: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine similarity of ``(B, D)`` queries (any scale)
    against an ``(N, D)`` L2-normalized dictionary.

    Returns best-first ``(scores, indices)`` of shape ``(B, k)``, f32 and
    int64.
    """
    q = l2_normalize(queries.float())
    scores = q @ dictionary.float().T
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]
