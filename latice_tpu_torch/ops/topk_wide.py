"""Cosine top-k over a wide bf16 table on the tensor cores: a CUDA kernel
(K5) and its plain twin.

Replaces no TPU kernel: the JAX package's exact engine is
``jnp.dot(q, d.T, preferred_element_type=jnp.float32)`` and ``lax.top_k``,
which XLA runs on the MXU. K5 was added for pattern dictionary indexing
(`index.pattern_di`), whose features are the pixels (``D = H*W / bin²``,
16,384 unbinned): there the exact engine made an f32 copy of the whole
table and a ``(B, N)`` score matrix on every batch, and multiplied on the
CUDA cores. K1 (`ops.topk_fused`) keeps a narrow feature axis and cannot
take it. The kernel is ``csrc/topk_wide.cu``; its source note gives the
design (TMA loads into a ring of stages, ``wgmma`` with f32 accumulators,
a keyed running top-k per query in the epilogue, a sorting merge).

Contract: ``topk_lower_index_first(q.float() @ table.float().T, k)`` for
``(B, D)`` bf16 queries (already normalized) over an ``(N, D)`` bf16 table.
Products are exact in f32 and sums are in f32 (the tensor cores' bf16
products with f32 accumulators), so the scores differ from the plain
twin's only by how the sums round: the tensor cores drop each step's bits
below the running sum's last place, so over D / 16 steps a score near 1
drifts by up to about D / 16 half-places (~1e-4 at D = 16,384; the twin's
cuBLAS f32 product ~1e-6). The order is best first, the lower row first
among equal scores. Nothing of size ``B x N`` or ``N x D`` is allocated:
the scratch is ``(B, splits, k)`` keys. On the card ``k`` is at most
`MAX_K` and ``D`` a multiple of 8 (TMA reads rows of whole 16-byte
chunks); the wrapper raises on anything else.

Bound on the H100: ``max(2·B·N·D / 989e12, (N + B)·D·2 bytes / 3.35e12)``.
At the DI cell's shapes (B=256, N=333,227, D=16,384) the table's 10.9 GB
take 3.26 ms and the 2.80 TFLOP 2.83 ms, so a batch sits just below the
ridge (256 FLOP a byte against the card's 295).

Routes: `index.pipeline.IndexPipeline._search` takes K5 for the exact
engine over a bf16 table on one device. The f32 table
(``search_dtype="float32"``), the mesh path
(`parallel.sharded_cosine_topk_inner`) and `index.pattern_di.StreamedPatternDI`
keep their own routes.

`cosine_topk_wide` launches the kernels on CUDA tensors and runs the plain
version `cosine_topk_wide_plain` on CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from latice_tpu_torch.ops import _build
from latice_tpu_torch.utils.profiling import count

__all__ = ["MAX_K", "cosine_topk_wide", "cosine_topk_wide_plain", "plan"]

MAX_K = 1024  # as kMaxK in the source
BN = 128  # table rows a tile (kBN)
MERGE_KEYS = 16_384  # keys the merge sorts in shared memory (kMergeKeys)


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}], the table's rows")


def cosine_topk_wide_plain(
    queries: torch.Tensor, table: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain torch: the f32 product of the operands
    as they are, then `index.knn.topk_lower_index_first`."""
    from latice_tpu_torch.index.knn import cosine_scores, topk_lower_index_first

    _check_k(k, table.shape[0])
    return topk_lower_index_first(cosine_scores(queries, table), k)


def plan(b: int, n: int, k: int, sms: int) -> dict:
    """The launch of K5 for ``b`` queries over ``n`` rows on a card of
    ``sms`` SMs: the consumer warpgroups a block (two of 128 queries, one
    where the batch has no more than 128), the query chunks of that many
    queries, and the splits of the table's `BN`-row tiles, as many as fill
    one wave of ``sms`` blocks with no split left empty and no more than the
    merge can sort (``splits * k`` keys of at most `MERGE_KEYS`);
    ``merge_keys`` is that count rounded up to a power of two."""
    consumers = 1 if b <= 128 else 2
    q_chunks = math.ceil(b / (128 * consumers))
    n_tiles = math.ceil(n / BN)
    most = max(1, min(n_tiles, sms // q_chunks, MERGE_KEYS // k))
    per_split = math.ceil(n_tiles / most)
    splits = math.ceil(n_tiles / per_split)
    return dict(consumers=consumers, q_chunks=q_chunks, splits=splits, tiles_per_split=per_split,
                merge_keys=1 << (splits * k - 1).bit_length())


def cosine_topk_wide(
    queries: torch.Tensor, table: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``(B, D)`` bf16 queries against an ``(N, D)`` bf16
    table, scored in f32; best-first ``(B, k)`` f32 scores and int64 rows.

    On CUDA tensors this launches K5 and adds one to
    ``cosine_topk_wide.launches`` and to the profiler counter
    ``search.k5_launches``; on CPU tensors it runs `cosine_topk_wide_plain`.
    """
    n = table.shape[0]
    _check_k(k, n)
    if queries.device.type == "cpu" and table.device.type == "cpu":
        return cosine_topk_wide_plain(queries, table, k)
    if queries.device.type != "cuda" or queries.device != table.device:
        raise ValueError(
            "cosine_topk_wide takes queries and table on one CUDA device, "
            f"got {queries.device} and {table.device}"
        )
    if queries.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise ValueError(f"cosine_topk_wide takes bfloat16, got {queries.dtype} and {table.dtype}")
    if queries.dim() != 2 or table.dim() != 2 or queries.shape[1] != table.shape[1]:
        raise ValueError(
            f"cosine_topk_wide takes (B, D) and (N, D), got {tuple(queries.shape)} "
            f"and {tuple(table.shape)}"
        )
    b, d = queries.shape
    if k > MAX_K:
        raise ValueError(f"k={k}: K5 keeps at most {MAX_K} candidates a query on the card")
    if d % 8:
        raise ValueError(f"D={d}: K5 reads rows of whole 16-byte chunks, D a multiple of 8")
    if not (queries.is_contiguous() and table.is_contiguous()):
        raise ValueError("cosine_topk_wide takes contiguous tensors")
    if queries.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("cosine_topk_wide takes 16-byte aligned tensors")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows do not fit K5's 32-bit row field")
    dev = queries.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out_v, out_i
    p = plan(b, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((b, p["splits"], k), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.latice_cosine_topk_wide(
            queries.data_ptr(), table.data_ptr(), part.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), b, n, d, k, p["consumers"], p["tiles_per_split"], p["splits"],
            p["merge_keys"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "cosine_topk_wide")
    cosine_topk_wide.launches += 1
    count("search.k5_launches")
    return out_v, out_i


cosine_topk_wide.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_wide")
    fn = lib.latice_cosine_topk_wide
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
