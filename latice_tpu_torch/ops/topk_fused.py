"""Fused cosine scores + exact top-k: a CUDA kernel and its plain twin.

Replaces ``latice_tpu/ops/topk_fused.py:cosine_topk_fused`` (body
``_topk_kernel``, merge ``_extract_topk_tile``). The kernel is
``csrc/topk_fused.cu``; its source note says what bounds it on the card and
how it is laid out. The (B, N) score matrix never reaches device memory.

Contract, as in the JAX function: queries are L2-normalized here, the
dictionary is taken as already normalized, columns at or past ``n_valid``
score -inf, and the result is the best-first ``(B, k)`` f32 scores and
int64 indices, ties going to the lowest index (``lax.top_k``'s order).

`cosine_topk_fused` launches the kernel on CUDA tensors and runs the plain
version `cosine_topk_fused_plain` on CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from latice_tpu_torch.ops import _build

__all__ = ["cosine_topk_fused", "cosine_topk_fused_plain"]

_MAX_K = 64
_MAX_D = 64
_WARPS_PER_BLOCK = 8  # as kWarps in the source
_QUERIES_PER_WARP = (4, 1)  # the kernel's template set, largest first
_MIN_SPLIT_ROWS = 1024
_BLOCKS_PER_SM = 2


def _check_k(k: int, n: int) -> None:
    if k > n:
        raise ValueError(f"k={k} exceeds dictionary size {n}")
    if k > _MAX_K:
        raise ValueError(
            f"k={k}: the fused kernel keeps k candidates per lane in registers "
            "and is built for the product's k <= ~32 candidate counts (at most "
            f"{_MAX_K}); use index.knn.cosine_topk for large k"
        )
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")


def cosine_topk_fused_plain(
    queries: torch.Tensor,
    dictionary: torch.Tensor,
    k: int,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain torch: normalized scores with the -inf
    mask, a stable descending sort (lowest index first on ties), the first
    ``k`` columns."""
    from latice_tpu_torch.index.knn import l2_normalize

    n = dictionary.shape[0]
    _check_k(k, n)
    q = l2_normalize(queries.float())
    scores = q @ dictionary.float().T
    if n_valid is not None and n_valid < n:
        scores[:, n_valid:] = float("-inf")
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def cosine_topk_fused(
    queries: torch.Tensor,
    dictionary: torch.Tensor,
    k: int,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine search; ``(B, D)`` queries against an ``(N, D)``
    normalized dictionary, ``D <= 64``, ``k <= 64``.

    On CUDA tensors this launches ``csrc/topk_fused.cu`` and adds one to
    ``cosine_topk_fused.launches``; on CPU tensors it runs
    `cosine_topk_fused_plain`.
    """
    n = dictionary.shape[0]
    _check_k(k, n)
    if queries.device.type == "cpu" and dictionary.device.type == "cpu":
        return cosine_topk_fused_plain(queries, dictionary, k, n_valid)
    if queries.device.type != "cuda" or queries.device != dictionary.device:
        raise ValueError(
            "cosine_topk_fused takes queries and dictionary on one CUDA device, "
            f"got {queries.device} and {dictionary.device}"
        )
    if queries.dtype != torch.float32 or dictionary.dtype != torch.float32:
        raise ValueError(
            f"cosine_topk_fused takes float32, got {queries.dtype} and {dictionary.dtype}"
        )
    if queries.dim() != 2 or dictionary.dim() != 2 or queries.shape[1] != dictionary.shape[1]:
        raise ValueError(
            f"cosine_topk_fused takes (B, D) and (N, D), got {tuple(queries.shape)} "
            f"and {tuple(dictionary.shape)}"
        )
    if not (queries.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("cosine_topk_fused takes contiguous tensors")
    b, d = queries.shape
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"cosine_topk_fused takes 1 <= D <= {_MAX_D}, got D={d}")
    n_valid = n if n_valid is None else min(int(n_valid), n)
    dev = queries.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out_v, out_i
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qw, splits = _plan(b, n, k, d, sms)
    part_v = part_i = tops = None
    if splits > 1:
        part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
        tops = torch.empty((b, 32), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.latice_cosine_topk_fused(
            queries.data_ptr(), dictionary.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            None if part_v is None else part_v.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            None if tops is None else tops.data_ptr(),
            b, n, d, k, n_valid, splits, qw, stream,
        )
    _build.check(lib, code, "cosine_topk_fused")
    cosine_topk_fused.launches += 1
    return out_v, out_i


cosine_topk_fused.launches = 0


def _plan(b: int, n: int, k: int, d: int, sms: int) -> tuple[int, int]:
    """(queries per warp, splits) for ``b`` queries against ``n`` rows of
    width ``d`` on a card of ``sms`` SMs.

    A warp scores each row it loads against its queries, so it takes as
    many as B fills: the largest of `_QUERIES_PER_WARP` with at least one
    whole block of queries. The dictionary is then cut into splits so that
    about `_BLOCKS_PER_SM` blocks per SM have work, each split keeping at
    least ``max(_MIN_SPLIT_ROWS, k)`` rows. ``d`` does not change the plan.
    Four queries per warp, not eight: on an H100 at B=256 the extra query
    blocks halve the splits, and with them each query's list fills and
    merges, which costs more than the shared loads eight would save
    (PERF.md).
    """
    qw = next(q for q in _QUERIES_PER_WARP if q == 1 or b >= q * _WARPS_PER_BLOCK)
    query_blocks = math.ceil(b / (qw * _WARPS_PER_BLOCK))
    want = math.ceil(_BLOCKS_PER_SM * sms / query_blocks)
    return qw, max(1, min(want, n // max(_MIN_SPLIT_ROWS, k)))


def _split_bounds(n: int, splits: int) -> list[int]:
    """The first row of each split, then ``n``: split ``s`` scores rows
    ``[bounds[s], bounds[s + 1])``, as the kernel cuts them."""
    return [s * n // splits for s in range(splits + 1)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_fused")
    fn = lib.latice_cosine_topk_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
