"""Dictionary-sharded exact k-NN over a device mesh: the port of
``latice_tpu.parallel.sharded_knn``.

For dictionaries beyond one card's memory: the dictionary rows are
partitioned over the mesh, every device computes the top-k against its
shard with the port's single-device engine (the fused engine launches the
CUDA kernel `ops.cosine_topk_fused` once per shard), and the per-shard
candidates are merged: each shard's ``(B, k)`` scores and re-based global
indices are copied to the mesh's first device, where one selection over the
``devices * k`` candidates keeps the best ``k``, ties to the lower global
index as ``lax.top_k`` keeps them.

Communication is O(devices * B * k) scalars, independent of the dictionary
size N. The host never waits inside the per-shard loop: every shard's work
is enqueued before the merge.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from latice_tpu_torch.index.knn import (
    _int8_products,
    _l2_normalize_sequential,
    approx_topk,
    cosine_scores,
    l2_normalize,
    pad_rows,
    quantize_dictionary_int8,
    topk_lower_index_first,
)
from latice_tpu_torch.ops.topk_fused import cosine_topk_fused
from latice_tpu_torch.parallel.mesh import Mesh

__all__ = ["ShardedRows", "shard_dictionary", "sharded_cosine_topk", "sharded_cosine_topk_inner"]

_ENGINES = ("exact", "approx", "int8", "fused")
# Below any int8 accumulator (|acc| <= D * 127**2), and times 2**32 it still
# fits int64: the order key of a padded row in the int8 engine.
_INT8_MASK_KEY = -(1 << 31)


class ShardedRows:
    """An ``(N, D)`` table held as equal row blocks, one per mesh device.

    ``shards[i]`` lives on ``mesh.devices[i]`` and holds rows
    ``[i * shard_rows, (i + 1) * shard_rows)``; ``shape`` and ``dtype`` are
    those of the whole (padded) table.
    """

    def __init__(self, shards: list[torch.Tensor], mesh: Mesh) -> None:
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.shards = shards
        self.mesh = mesh

    @property
    def shard_rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.shard_rows * len(self.shards), self.shards[0].shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def shard_dictionary(dictionary, mesh: Mesh) -> ShardedRows:
    """Place an (N, D) dictionary row-sharded over the mesh.

    Non-divisible N is padded with zero rows; the search functions mask the
    padded positions to -inf via ``n_valid`` (cosine scores can be negative,
    so a zero row's score of 0 could otherwise outrank real matches).
    Any dtype shards: pass an int8-quantized dictionary
    (`index.knn.quantize_dictionary_int8`) to compose the quantized engine
    with mesh sharding. A numpy table is padded on the host and each block
    is copied straight to its own device, so the whole table never lands on
    one card; a tensor is split where it lies.
    """
    n = mesh.size
    pad = -dictionary.shape[0] % n
    if isinstance(dictionary, np.ndarray):
        if pad:
            dictionary = np.concatenate(
                [dictionary, np.zeros((pad, dictionary.shape[1]), dictionary.dtype)]
            )
    elif pad:
        dictionary = torch.cat([dictionary, dictionary.new_zeros((pad, dictionary.shape[1]))])
    rows = dictionary.shape[0] // n
    shards = []
    for i, dev in enumerate(mesh.devices):
        block = dictionary[i * rows : (i + 1) * rows]
        if isinstance(block, np.ndarray):
            # A copy where the source is read-only (a memmap, a JAX buffer).
            block = torch.from_numpy(
                np.ascontiguousarray(block) if block.flags.writeable else np.array(block)
            )
        shards.append(block.to(dev).contiguous())
    return ShardedRows(shards, mesh)


def sharded_cosine_topk(
    queries,
    dictionary_sharded: ShardedRows,
    k: int,
    mesh: Mesh,
    n_valid: int | None = None,
    engine: str = "exact",
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded dictionary; ``(B, k)`` results on the
    mesh's first device.

    Args:
        queries: (B, D), host numpy or a tensor (placed on the mesh's first
            device as f32 by this call).
        dictionary_sharded: `shard_dictionary`'s table; L2-normalized float
            for "exact"/"approx"/"fused" (a bf16 table is multiplied by
            the f32 queries, as the JAX package's sharded search does),
            int8-quantized (`quantize_dictionary_int8`) for "int8".
        k: neighbours.
        mesh: the device mesh.
        n_valid: number of genuine dictionary rows; rows at index >= n_valid
            are padding from `shard_dictionary` and are masked to -inf.
            Defaults to all rows.
        engine: per-shard selection engine: "exact" (scores, then the
            top-k in ``lax.top_k``'s order), "approx"
            (`index.knn.approx_topk`), "int8" (exact int32 products against
            a quantized shard) or "fused" (the CUDA kernel
            `ops.cosine_topk_fused` on a card, its plain twin on the CPU).
            The merge is the same for every engine.
        recall_target: the approx engine's target recall.

    Returns:
        (scores f32, indices int64) with **global** dictionary indices,
        best-first: those of the unsharded engine on the same data (to the
        engine's accuracy).
    """
    if isinstance(queries, np.ndarray):
        queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    queries = queries.to(mesh.devices[0], torch.float32)
    return sharded_cosine_topk_inner(
        queries, dictionary_sharded, k, mesh, n_valid,
        engine=engine, recall_target=recall_target,
    )


def sharded_cosine_topk_inner(
    queries: torch.Tensor,
    dictionary_sharded: ShardedRows,
    k: int,
    mesh: Mesh,
    n_valid: int | None = None,
    engine: str = "exact",
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The core of `sharded_cosine_topk`: ``queries`` is a ``(B, D)``
    device tensor (any scale; copied to each shard's device here)."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown sharded engine {engine!r}")
    if len(dictionary_sharded.shards) != mesh.size:
        raise ValueError(
            f"dictionary has {len(dictionary_sharded.shards)} shards, mesh has {mesh.size} devices"
        )
    shard_rows = dictionary_sharded.shard_rows
    n_total = dictionary_sharded.shape[0]
    k_local = min(k, shard_rows)
    n_valid = n_total if n_valid is None else int(n_valid)
    if engine == "int8":
        q_unit = _l2_normalize_sequential(queries)
        q_base, _ = quantize_dictionary_int8(q_unit)
    elif engine == "fused":
        q_base = queries.float().contiguous()  # the kernel normalizes
    else:
        # f32 queries against each shard in its own dtype, products and sums
        # in f32 (`cosine_scores`): the JAX package's sharded search. Only
        # the one-device bf16 engine rounds its queries too.
        q_base = l2_normalize(queries.float())
    parts_s, parts_i = [], []
    for shard_id, (dev, shard) in enumerate(zip(mesh.devices, dictionary_sharded.shards)):
        offset = shard_id * shard_rows
        nv_local = min(max(n_valid - offset, 0), shard_rows)
        q = q_base.to(dev, non_blocking=True)
        if engine == "fused":
            local_s, local_i = cosine_topk_fused(q, shard, k_local, n_valid=nv_local)
        elif engine == "int8":
            local_s, local_i = _int8_shard_topk(q, shard, k_local, nv_local)
        else:
            scores = cosine_scores(q, shard)
            if nv_local < shard_rows:
                scores[:, nv_local:] = -math.inf
            if engine == "approx":
                local_s, local_i = approx_topk(scores, k_local, recall_target)
            else:
                local_s, local_i = topk_lower_index_first(scores, k_local)
        parts_s.append(local_s.to(mesh.devices[0], non_blocking=True))
        parts_i.append((local_i + offset).to(mesh.devices[0], non_blocking=True))
    # Shard order along the merged axis: among equal scores the lower
    # position is the lower global index, so the merge keeps lax.top_k's
    # tie order.
    merged_s = torch.cat(parts_s, dim=1)
    merged_i = torch.cat(parts_i, dim=1)
    best_s, sel = topk_lower_index_first(merged_s, k)
    return best_s, merged_i.gather(1, sel)


def _int8_shard_topk(qi: torch.Tensor, shard: torch.Tensor, k: int, n_valid: int):
    """`index.knn.cosine_topk_int8` against one shard whose rows from
    ``n_valid`` on are padding: those score -inf and sort below every real
    row, instead of being cut off (a shard may hold fewer real rows than
    ``k``)."""
    rows = shard.shape[0]
    di = pad_rows(shard) if shard.device.type == "cuda" else shard
    acc = _int8_products(qi, di)[:, :rows]
    scores = acc.float() * (1.0 / (127.0 * 127.0))
    key = acc.to(torch.int64)
    if n_valid < rows:
        scores[:, n_valid:] = -math.inf
        key[:, n_valid:] = _INT8_MASK_KEY
    return topk_lower_index_first(scores, k, key=key)
