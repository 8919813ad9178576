"""Frozen arithmetic of the pattern DI cells: the search's model FLOPs and
the operations and bytes of K5, the port's cosine top-k over a wide bf16
table (`latice_tpu_torch/ops/topk_wide.py`).

The search of one pattern scores it against every dictionary row: ``2·N·D``
FLOPs (a multiply-add is two) over ``N`` rows of ``D = (S / bin)²``
features. K5 reads the bf16 queries and the bf16 table once and writes
``k`` (f32 score, int64 row) pairs a query, and is bounded by the larger of
its operations at the dense bf16 peak and its bytes at HBM's rate
(`yardstick`'s peaks, NVIDIA's data sheet for the H100 SXM at 700 W).
"""

from __future__ import annotations

from port_bench.yardstick import PEAK_BF16, PEAK_BYTES

__all__ = ["feature_dim", "k5_bound_s", "k5_bytes", "k5_ops", "rows", "search_flops"]


def feature_dim(cfg: dict) -> int:
    """Features a row: the pattern's pixels after binning."""
    return (cfg["image_size"] // cfg["bin_factor"]) ** 2


def rows(cfg: dict) -> int:
    """Dictionary rows over every phase."""
    return cfg["dictionary_rows"] * len(cfg["phases"])


def search_flops(cfg: dict) -> float:
    """Model FLOPs of one pattern's search."""
    return 2.0 * rows(cfg) * feature_dim(cfg)


def k5_ops(batch: int, n: int, dim: int) -> float:
    return 2.0 * batch * n * dim


def k5_bytes(batch: int, n: int, dim: int, k: int) -> float:
    return 2.0 * (n + batch) * dim + 12.0 * batch * k


def k5_bound_s(batch: int, n: int, dim: int, k: int) -> float:
    """Bound of one K5 call: ``batch`` queries over ``n`` rows of ``dim``."""
    return max(k5_bytes(batch, n, dim, k) / PEAK_BYTES, k5_ops(batch, n, dim) / PEAK_BF16)
