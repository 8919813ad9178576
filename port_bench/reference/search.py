"""Cosine top-k as a matrix product and ``torch.topk``, float32, TF32 off."""

from __future__ import annotations

import torch

from port_bench.reference.vae import full_f32

__all__ = ["cosine_scores", "normalize"]


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def cosine_scores(queries: torch.Tensor, dictionary: torch.Tensor, rows: int = 256) -> torch.Tensor:
    """``(B, N)`` cosine scores of raw ``queries`` against unit
    ``dictionary`` rows, in blocks of ``rows`` queries."""
    out = []
    with full_f32():
        for i in range(0, len(queries), rows):
            out.append(normalize(queries[i : i + rows]) @ dictionary.float().T)
    return torch.cat(out)
