"""Cosine k-NN engines: exact, approximate, int8, blocked and host-streamed.

The port of ``latice_tpu.index.knn``. Every engine scores ``Q @ Dᵀ`` with
L2-normalized queries and selects as ``lax.top_k`` does: best first, and on
equal scores the lower index first (``torch.topk`` promises no tie order,
so the selection runs on an int64 key that packs the score's order above
the reversed position, `topk_lower_index_first`). The fused engine, whose
scores never reach device memory, is `ops.cosine_topk_fused`.

f32 products stay f32: PyTorch's matmuls do not use TF32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set. bf16 operands are
multiplied as f32 (their products are exact there), so the scores carry
the inputs' rounding only, as JAX's ``preferred_element_type=float32``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "approx_bins",
    "approx_topk",
    "cosine_scores",
    "cosine_topk",
    "cosine_topk_approx",
    "cosine_topk_blocked",
    "cosine_topk_int8",
    "cosine_topk_streamed",
    "l2_normalize",
    "pad_rows",
    "quantize_dictionary_int8",
    "topk_lower_index_first",
]

INT8_SCALE = 127.0


def l2_normalize(vectors: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Row-wise L2 normalization; zero rows stay zero instead of NaN."""
    norms = torch.linalg.vector_norm(vectors, dim=dim, keepdim=True)
    return vectors / torch.where(norms == 0, torch.ones_like(norms), norms)


def _l2_normalize_sequential(vectors: torch.Tensor) -> torch.Tensor:
    """`l2_normalize` of ``(B, D)`` f32 rows with the squares summed in
    column order, each step rounded once as a fused multiply-add: the order
    of XLA's CPU backend, and the same bits on every torch device (a
    reduction kernel's order differs between the CPU and CUDA). The int8
    engine rounds these values to integers, so their bits matter."""
    v = vectors.float()
    acc = torch.zeros(v.shape[0], dtype=torch.float64, device=v.device)
    for j in range(v.shape[1]):
        col = v[:, j].double()
        acc = (acc + col * col).float().double()  # exact square, one rounding
    norms = acc.float().sqrt()[:, None]
    return v / torch.where(norms == 0, torch.ones_like(norms), norms)


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """int64 image of f32 scores in XLA's total order (-0.0 below +0.0)."""
    bits = scores.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


def topk_lower_index_first(
    scores: torch.Tensor, k: int, key: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along dim 1: the ``k`` largest of ``(B, N)`` scores,
    best first, the lower position first among equal ones.

    ``key`` is an optional integer tensor with the scores' order (the int8
    engine's exact accumulators); by default the scores' own bits. It is
    packed as ``key * 2**32 + (2**32 - 1 - position)``, so every entry is
    distinct and one ``torch.topk`` gives the order without a full sort.
    Returns ``(scores, positions)``, positions int64.
    """
    n = scores.shape[1]
    if n >= 1 << 32:
        raise ValueError(f"{n} columns do not fit the 32-bit position field")
    packed = _order_key(scores) if key is None else key.to(torch.int64, copy=True)
    packed = packed.mul_(1 << 32).add_(
        (1 << 32) - 1 - torch.arange(n, dtype=torch.int64, device=scores.device)
    )
    pos = torch.topk(packed, k, dim=1).indices
    return scores.gather(1, pos), pos


def cosine_scores(queries_unit: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` f32 scores of L2-normalized queries against the
    dictionary; operands in bf16 or f16 are multiplied as f32, so only
    their own rounding shows."""
    d = dictionary if dictionary.dtype == torch.float32 else dictionary.float()
    return queries_unit.float() @ d.T


def cosine_topk(
    queries: torch.Tensor, dictionary: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine similarity of ``(B, D)`` queries (any scale)
    against an ``(N, D)`` L2-normalized dictionary.

    Returns best-first ``(scores, indices)`` of shape ``(B, k)``, f32 and
    int64.
    """
    return topk_lower_index_first(cosine_scores(l2_normalize(queries.float()), dictionary), k)


def approx_bins(n: int, k: int, recall_target: float) -> tuple[int, int]:
    """``(bins, width)`` of `approx_topk` over ``n`` scores.

    XLA's model of ``approx_max_k``: when each of ``M`` bins keeps only its
    maximum, a true top-k entry survives unless another of the top k falls
    in its bin, so recall ≈ ``(1 - 1/M)**(k-1)`` ≈ ``exp((1 - k) / M)``,
    which gives ``M = (1 - k) / ln(recall_target)``. As XLA does, ``M`` is
    at least 128 (and at most ``n``), the bin width ``n / M`` is rounded
    down to a power of two, and ``n`` at most 128 or a target of 1 is not
    binned (width 1).
    """
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")
    if recall_target == 1.0 or n <= 128:
        return n, 1
    m = min(max(int((1.0 - k) / math.log(recall_target)), 128), n)
    log2_width = (n // m).bit_length() - 1
    width = 1 << log2_width
    return -(-n // width), width


def approx_topk(
    scores: torch.Tensor, k: int, recall_target: float = 0.95
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k of ``(B, N)`` scores, the algorithm of
    ``lax.approx_max_k`` on the TPU: row ``j`` falls in bin ``j % M``
    (`approx_bins`), each bin keeps its maximum (the lower index on ties),
    and the exact top-k of the ``M`` maxima is returned, best first."""
    b, n = scores.shape
    bins, width = approx_bins(n, k, recall_target)
    if width == 1 or bins < k:
        return topk_lower_index_first(scores, k)
    pad = bins * width - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=-math.inf)
    best, row_in_bin = scores.reshape(b, width, bins).max(dim=1)
    vals, pos = topk_lower_index_first(best, k)
    return vals, row_in_bin.gather(1, pos) * bins + pos


def cosine_topk_approx(
    queries: torch.Tensor, dictionary: torch.Tensor, k: int, recall_target: float = 0.95
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k cosine search: the exact engine's scores,
    `approx_topk`'s selection. Held to recall, not to indices."""
    scores = cosine_scores(l2_normalize(queries.float()), dictionary)
    return approx_topk(scores, k, recall_target)


def quantize_dictionary_int8(dictionary):
    """Symmetric int8 quantization of an L2-normalized dictionary.

    Normalized rows lie in [-1, 1], so one global scale of 127 applies
    (round half to even, clipped to ±127). Returns the int8 matrix and the
    dequantization scale 1/127. A numpy array stays on the host; a tensor
    quantizes on its device.
    """
    if isinstance(dictionary, np.ndarray):
        d = dictionary.astype(np.float32, copy=False)
        return np.clip(np.round(d * INT8_SCALE), -127, 127).astype(np.int8), 1.0 / INT8_SCALE
    d = dictionary.float()
    return torch.clamp(torch.round(d * INT8_SCALE), -127, 127).to(torch.int8), 1.0 / INT8_SCALE


def pad_rows(dictionary: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """The dictionary with zero rows appended up to a multiple of
    ``multiple`` (the int8 tensor-core product wants N % 8 == 0)."""
    extra = -dictionary.shape[0] % multiple
    if not extra:
        return dictionary
    return torch.cat([dictionary, dictionary.new_zeros((extra, dictionary.shape[1]))])


def _int8_products(qi: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``qi @ diᵀ`` of int8 operands.

    On the card ``torch._int_mm`` (the int8 tensor cores), which needs more
    than 16 query rows and N and D multiples of 8: queries are padded to 17
    or more rows and the product sliced back. On the CPU an f64 product,
    exact here since |acc| <= D * 127**2 is far below 2**53.
    """
    b, d = qi.shape
    if qi.device.type != "cuda":
        return (qi.double() @ di.double().T).to(torch.int32)
    if d % 8 or di.shape[0] % 8:
        raise ValueError(f"int8 product needs D and N multiples of 8, got D={d}, N={di.shape[0]}")
    rows = max(17, -(-b // 8) * 8)
    if rows != b:
        qi = torch.cat([qi, qi.new_zeros((rows - b, d))])
    return torch._int_mm(qi, di.T)[:b]


def cosine_topk_int8(
    queries: torch.Tensor, dictionary_int8: torch.Tensor, k: int, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine search against an int8 dictionary.

    The queries are normalized (in XLA's CPU order,
    `_l2_normalize_sequential`) and quantized as the dictionary is; the
    int32 accumulator is exact, so the scores ``acc / 127**2`` (a product
    with the f32 reciprocal, as XLA compiles the division) and their order
    are the same on every device. ``n_valid`` counts the real rows when the
    dictionary carries zero padding (`pad_rows`); on the card an unpadded
    dictionary is padded here, per call.
    """
    n = dictionary_int8.shape[0] if n_valid is None else n_valid
    di = dictionary_int8
    if di.device.type == "cuda":
        di = pad_rows(di)
    qi, _ = quantize_dictionary_int8(_l2_normalize_sequential(queries))
    acc = _int8_products(qi, di)[:, :n]
    # acc / 127**2 as XLA computes it: times the reciprocal, rounded to f32
    # (a Python scalar meets an f32 tensor in f32).
    scores = acc.float() * (1.0 / (INT8_SCALE * INT8_SCALE))
    return topk_lower_index_first(scores, k, key=acc)


def _merge(
    run_s: torch.Tensor, run_i: torch.Tensor, s: torch.Tensor, i: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of the running list followed by a new one: on equal
    scores the running entry (the lower index) stays first."""
    merged_s, sel = topk_lower_index_first(torch.cat([run_s, s], dim=1), k)
    return merged_s, torch.cat([run_i, i], dim=1).gather(1, sel)


def _block_topk(q: torch.Tensor, block: torch.Tensor, n_valid: int, k_local: int):
    """Scores of one block, rows past ``n_valid`` at -inf, and their top
    ``k_local`` (the block's scores padded with -inf up to ``k_local``)."""
    scores = cosine_scores(q, block)
    if n_valid < scores.shape[1]:
        scores[:, n_valid:] = -math.inf
    if scores.shape[1] < k_local:
        scores = torch.nn.functional.pad(scores, (0, k_local - scores.shape[1]), value=-math.inf)
    return topk_lower_index_first(scores, k_local)


def cosine_topk_blocked(
    queries: torch.Tensor, dictionary: torch.Tensor, k: int, block_size: int = 131072
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a dictionary scored ``block_size`` rows at a time, with a
    running ``(B, k)`` merge: memory O(B * block_size), not O(B * N).

    Rows past the end are scored -inf inside each block (a zero row would
    score 0 and outrank negative matches). Entries that are not real rows,
    possible only when ``k > N``, come back as ``(-inf, 0)``.
    """
    n = dictionary.shape[0]
    q = l2_normalize(queries.float())
    b = q.shape[0]
    k_local = min(k, block_size)
    run_s = torch.full((b, k), -math.inf, device=q.device)
    run_i = torch.zeros((b, k), dtype=torch.int64, device=q.device)
    for start in range(0, n, block_size):
        block = dictionary[start : start + block_size]
        s, i = _block_topk(q, block, block.shape[0], k_local)
        run_s, run_i = _merge(run_s, run_i, s, i + start, k)
    valid = run_i < n
    return torch.where(valid, run_s, -math.inf), torch.where(valid, run_i, 0)


def _host_chunks(dictionary, chunk_rows: int):
    """``chunk_rows``-row host chunks of a numpy array, memmap or CPU
    tensor, the last one zero-padded; f64 numpy rows become f32 (as JAX
    stores them) and other dtypes stay as they are."""
    n, d = dictionary.shape
    for start in range(0, n, chunk_rows):
        c = dictionary[start : start + chunk_rows]
        if isinstance(c, torch.Tensor):
            if len(c) < chunk_rows:
                c = torch.cat([c, c.new_zeros((chunk_rows - len(c), d))])
            yield c
            continue
        c = np.asarray(c)
        if c.dtype not in (np.float32, np.float16):
            c = c.astype(np.float32)
        elif not c.flags.writeable:  # a read-only memmap's rows
            c = c.copy()
        if len(c) < chunk_rows:
            c = np.concatenate([c, np.zeros((chunk_rows - len(c), d), c.dtype)])
        yield c


def _streamed_topk_step(q, chunk, base, n_valid, run_s, run_i, *, k, k_local):
    """One fold of `cosine_topk_streamed`: score a chunk, merge the top-k.
    f32 chunks keep f32 products; other chunks meet the queries rounded to
    their dtype, as JAX casts them."""
    qq = q if chunk.dtype == torch.float32 else q.to(chunk.dtype)
    s, i = _block_topk(qq, chunk, n_valid, k_local)
    return _merge(run_s, run_i, s, i + base, k)


def cosine_topk_streamed(
    queries,
    dictionary,
    k: int,
    chunk_rows: int = 131072,
    prefetch: int = 2,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k over a dictionary that stays in host memory.

    Rows go to the device ``chunk_rows`` at a time through
    `data.prefetch_to_device` (pinned host buffers, copies on a side stream,
    ``prefetch`` chunks in flight), with a running ``(B, k)`` merge, so the
    device holds O(chunk_rows * D + B * k), whatever N is.

    Args:
        queries: ``(B, D)`` tensor or array, normalized here in f32.
        dictionary: ``(N, D)`` rows, already L2-normalized: a numpy array or
            ``np.memmap`` (f32 or f16), or a CPU tensor (also bf16, which
            numpy has no type for; a pinned tensor is copied from directly).
        k: neighbours (at most N).
        chunk_rows: rows per transfer, the residency knob.
        prefetch: chunks in flight.
        device: where the scores are computed: the queries' device when they
            are a tensor, else ``cuda`` unless given.

    Returns:
        ``(scores, indices)`` on that device, equal to `cosine_topk` over the
        whole matrix for f32 rows.
    """
    from latice_tpu_torch.data.prefetch import prefetch_to_device
    from latice_tpu_torch.device import resolve_device

    n = dictionary.shape[0]
    if n == 0:
        raise ValueError("empty dictionary")
    if isinstance(queries, torch.Tensor):
        dev = queries.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
    chunk_rows = min(chunk_rows, n)
    k = min(k, n)
    k_local = min(k, chunk_rows)
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, np.float32))
    q = l2_normalize(queries.to(dev).float())
    b = q.shape[0]
    run_s = torch.full((b, k), -math.inf, device=dev)
    run_i = torch.zeros((b, k), dtype=torch.int64, device=dev)
    chunks = prefetch_to_device(_host_chunks(dictionary, chunk_rows), size=prefetch, device=dev)
    for start, chunk in zip(range(0, n, chunk_rows), chunks):
        run_s, run_i = _streamed_topk_step(
            q, chunk, start, min(chunk_rows, n - start), run_s, run_i, k=k, k_local=k_local
        )
    return run_s, run_i
