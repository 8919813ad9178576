"""End-to-end indexer: patterns in, orientations out, on one device or a mesh.

The port of ``latice_tpu.index.pipeline.IndexPipeline``. Per batch, on the
device: uint8 ``/255``, an optional preprocess, the VAE encoder's ``mu``,
the candidate search (`CandidateSearch`: the CUDA kernel
`ops.cosine_topk_fused` for ``engine="fused"``, the CUDA kernel
`ops.cosine_topk_wide` for "exact" over a bf16 table, the `index.knn`
engines for the rest of "exact", "approx" and "int8"), then the
symmetry-aware consensus and the Euler angles (`CandidateConsensus`: the
CUDA kernel `ops.candidate_consensus_fused`, one launch a batch), the
two stages of the latent database's queries too (`index.db`). One
host-to-device copy of the patterns and one device-to-host copy of the
results per batch; every batch of a call is enqueued before the first
result is copied back.

With ``mesh=`` (`parallel.make_mesh`) each batch splits over the mesh's
devices, each block encoded by that device's replica of the model; the
latents gather on the first device, the dictionary is row-sharded and
searched shard by shard (`parallel.sharded_cosine_topk_inner`), and the
consensus runs on the first device.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal import from_euler_zxz_deg, stack_symmetry_tables
from latice_tpu_torch.data import pad_batch, padded_batches
from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.index.knn import (
    approx_topk,
    cosine_scores,
    cosine_topk_int8,
    l2_normalize,
    pad_rows,
    quantize_dictionary_int8,
    topk_lower_index_first,
)
from latice_tpu_torch.ops.consensus_fused import ConsensusResult, candidate_consensus_fused
from latice_tpu_torch.ops.topk_fused import cosine_topk_fused
from latice_tpu_torch.ops.topk_wide import cosine_topk_wide
from latice_tpu_torch.parallel.mesh import check_mesh_device, gather_rows, replicate, shard_batch
from latice_tpu_torch.utils.profiling import count, span

__all__ = [
    "CandidateConsensus",
    "CandidateSearch",
    "DenseIndexResult",
    "IndexPipeline",
    "as_preprocess_fn",
    "collect_results",
    "concat_dense_results",
    "device_batches",
    "model_units",
]


class DenseIndexResult(NamedTuple):
    """Bulk-indexing output as host numpy arrays."""

    mean_orientation: np.ndarray  # (B, 3) zxz deg; NaN rows where not success
    best_orientation: np.ndarray  # (B, 3) mean, or the top-1 candidate on failure
    success: np.ndarray  # (B,) bool
    n_similar: np.ndarray  # (B,) int
    indices: np.ndarray  # (B, K) dictionary rows of the candidates
    scores: np.ndarray  # (B, K) cosine similarities
    phase: np.ndarray | None = None  # (B,) int phase id (multi-phase dictionaries)


def concat_dense_results(results) -> DenseIndexResult:
    """Concatenate per-slab `DenseIndexResult`s."""
    results = list(results)
    if not results:
        raise ValueError("no results to concatenate")
    if len(results) == 1:
        return results[0]
    fields = {
        f: np.concatenate([getattr(r, f) for r in results])
        for f in DenseIndexResult._fields
        if f != "phase"
    }
    phase = None if results[0].phase is None else np.concatenate([r.phase for r in results])
    return DenseIndexResult(**fields, phase=phase)


class IndexPipeline:
    """Indexer over a fixed dictionary, on one device or a mesh.

    Args:
        model: the port's VAE (`models.VariationalAutoEncoderRawData`); it
            is moved to ``device`` and put in eval mode. ``None`` with a
            ``feature_fn``.
        dictionary_vectors: ``(N, D)`` L2-normalized rows: host numpy
            (taken as f32), or a tensor, moved to ``device`` in its dtype
            (a bf16 table stays bf16).
        dictionary_orientations: ``(N, 3)`` zxz Euler degrees.
        top_n / orientation_threshold / min_required_matches /
        max_iterations / angle_unit: consensus knobs (reference defaults
            dp_indexer.py:47-48, faiss_db.py:262-264).
        batch_size: rows per device batch; inputs are padded up to it.
        dictionary_phases: optional ``(N,)`` int phase id per entry; then
            only same-phase candidates count and results carry the phase.
        phase_symmetries: point-group names per phase id (default cubic).
        consensus_weight_power: optional p; in-threshold candidates are
            weighted by ``(s / s_max) ** p`` in the mean.
        engine: "exact" (matmul, then the top-k in ``lax.top_k``'s order;
            over a bf16 table on one device, both in one kernel,
            `ops.cosine_topk_wide`, which takes ``top_n`` up to 1,024 and
            feature widths in multiples of 8 on the card),
            "fused" (the CUDA kernel on the card, its plain twin on the
            CPU), "approx" (`index.knn.approx_topk`: binned maxima, held to
            ``recall_target``) or "int8" (a quantized dictionary and exact
            int32 products, `index.knn.cosine_topk_int8`).
        recall_target: the approx engine's target recall.
        device: where everything runs; ``cuda`` unless given, and a missing
            CUDA device raises. With ``mesh``, the mesh's first device (or
            None); any other device raises.
        mesh: optional `parallel.Mesh`: each batch shards over its devices
            for the encode (the model replicated), and the dictionary rows
            shard for the search, every engine per shard with one merge of
            the ``devices * k`` candidates on the first device.
            ``batch_size`` must divide by the mesh size.
        preprocess: optional correction of the ``(B, H, W)`` float32 device
            patterns, run after the uint8 ``/255`` and before the encoder (or
            ``feature_fn``): a callable, or a `data.PreprocessConfig`
            (compiled by `data.make_preprocess_fn`).
        feature_fn: optional map of the ``(B, H, W)`` float32 device
            patterns (after the uint8 ``/255``) to ``(B, D)`` features, used
            instead of the VAE's encode; pass ``model=None``. `encode` and
            the indexing call both go through it.
        search_dtype: "float32", or "bfloat16" for the exact and approx
            engines: the dictionary is stored in bf16 and the queries are
            rounded to bf16, while the products and scores stay f32. The
            fused and int8 engines ignore it.

    The dictionary is cast or quantized once, here (`CandidateSearch`).
    """

    def __init__(
        self,
        model: torch.nn.Module | None,
        dictionary_vectors,
        dictionary_orientations,
        top_n: int = 20,
        orientation_threshold: float = 3.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
        angle_unit: str = "deg",
        batch_size: int = 256,
        dictionary_phases=None,
        phase_symmetries=None,
        consensus_weight_power: float | None = None,
        engine: str = "exact",
        device: str | torch.device | None = None,
        mesh=None,
        preprocess=None,
        feature_fn=None,
        search_dtype: str = "float32",
        recall_target: float = 0.95,
    ) -> None:
        preprocess = as_preprocess_fn(preprocess)
        if feature_fn is None and model is None:
            raise ValueError("pass a model or a feature_fn")
        if feature_fn is not None and model is not None:
            raise ValueError("model and feature_fn are mutually exclusive")
        self.mesh = mesh
        if mesh is not None:
            self.device = check_mesh_device(mesh, device)
            if batch_size % mesh.size:
                raise ValueError(
                    f"batch_size {batch_size} must divide by mesh size {mesh.size}"
                )
        else:
            self.device = resolve_device(device)
        self.search = CandidateSearch(
            dictionary_vectors, self.device, engine=engine, search_dtype=search_dtype,
            recall_target=recall_target, mesh=mesh,
        )
        self.engine = engine
        self.batch_size = batch_size
        self.feature_fn = feature_fn
        self.preprocess = preprocess
        self.model = None if model is None else model.to(self.device).eval()
        self._replicas = None
        if mesh is not None and self.model is not None:
            self._replicas = replicate(self.model, mesh)
        self._k = min(top_n, self.search.n)
        self.consensus = CandidateConsensus(
            dictionary_orientations,
            self.device,
            dictionary_phases=dictionary_phases,
            phase_symmetries=phase_symmetries,
            orientation_threshold=orientation_threshold,
            min_required_matches=min_required_matches,
            max_iterations=min(max_iterations, self._k),
            angle_unit=angle_unit,
            consensus_weight_power=consensus_weight_power,
        )
        self.n_phases = self.consensus.n_phases

    def _encode(self, patterns) -> torch.Tensor:
        """``mu`` (or the ``feature_fn`` features) of ``(B, H, W)`` uint8 or
        f32 device patterns; with a mesh, of its per-device row blocks,
        gathered on the first device."""
        with span("index:encode"):
            if self.mesh is not None:
                models = self._replicas or [None] * self.mesh.size
                return gather_rows(
                    [self._encode_block(m, block) for m, block in zip(models, patterns)], self.mesh
                )
            return self._encode_block(self.model, patterns)

    def _encode_block(self, model, patterns: torch.Tensor) -> torch.Tensor:
        patterns = model_units(patterns, self.preprocess)
        if self.feature_fn is not None:
            return self.feature_fn(patterns)
        return model.encode(patterns[:, None])[0]

    def _search(self, mu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Best-first ``(scores, indices)`` of the ``(B, D)`` features
        (`CandidateSearch`)."""
        with span("index:search"):
            return self.search(mu, self._k)

    def _run(self, patterns: torch.Tensor) -> ConsensusResult:
        scores, indices = self._search(self._encode(patterns))
        return self.consensus(scores, indices)

    def _batches(self, patterns: np.ndarray):
        """``(n_real, batch)`` pairs: each batch on the device, or its
        per-device row blocks, each copied from the host to its device."""
        if self.mesh is not None:
            return ((n, shard_batch(chunk, self.mesh))
                    for n, chunk in padded_batches(_host_stack(patterns), self.batch_size))
        return device_batches(patterns, self.batch_size, self.device)

    @torch.inference_mode()
    def encode(self, patterns: np.ndarray) -> np.ndarray:
        """``(B, D)`` f32 latents of ``(B, H, W[, 1])`` patterns."""
        pending = [(n, self._encode(chunk)) for n, chunk in self._batches(patterns)]
        if not pending:
            return np.zeros((0, self.search.table.shape[1]), np.float32)
        return np.concatenate([mu[:n].cpu().numpy() for n, mu in pending])

    @torch.inference_mode()
    def __call__(self, patterns: np.ndarray) -> DenseIndexResult:
        """Index a stack of ``(B, H, W[, 1])`` uint8 or float patterns."""
        with span("index:call"):
            pending = []
            for n, chunk in self._batches(patterns):
                pending.append((n, self._run(chunk)))
                count("index.batches")
                count("index.patterns", n)
            return collect_results(pending, self._k, self.n_phases is not None)


def as_preprocess_fn(preprocess):
    """``preprocess`` as a function of a ``(B, H, W)`` device batch: None
    and callables as they are, a `data.PreprocessConfig` compiled by
    `data.make_preprocess_fn`; anything else raises ``TypeError``."""
    if preprocess is None or callable(preprocess):
        return preprocess
    from latice_tpu_torch.data.preprocess import PreprocessConfig, make_preprocess_fn

    if not isinstance(preprocess, PreprocessConfig):
        raise TypeError(
            "preprocess must be a callable or a data.PreprocessConfig,"
            f" got {type(preprocess).__name__}"
        )
    return make_preprocess_fn(preprocess)


def model_units(patterns: torch.Tensor, preprocess=None) -> torch.Tensor:
    """A device batch as the model or a feature map takes it: integers
    (uint8 detector frames) divided by 255 on the device, then the optional
    ``preprocess``."""
    if not torch.is_floating_point(patterns):
        patterns = patterns.float() / 255.0
    if preprocess is not None:
        patterns = preprocess(patterns)
    return patterns


def _host_stack(patterns: np.ndarray) -> np.ndarray:
    """A ``(B, H, W[, 1])`` host stack as ``(B, H, W)``: uint8 stays uint8
    (the device divides it by 255), other dtypes become float32."""
    x = np.asarray(patterns)
    if x.dtype != np.uint8:
        x = x.astype(np.float32, copy=False)
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.ndim != 3:
        raise ValueError(f"expected (B, H, W) or (B, H, W, 1) patterns, got {x.shape}")
    return x


def device_batches(patterns: np.ndarray, batch_size: int, device: torch.device):
    """``(n_real, device batch)`` pairs of a ``(B, H, W[, 1])`` host stack,
    each batch zero-padded to ``batch_size`` rows; uint8 stays uint8 (the
    device divides it by 255), other dtypes become float32."""
    x = _host_stack(patterns)
    for start in range(0, len(x), batch_size):
        with span("index:stage"):
            chunk, _, n = pad_batch(x[start : start + batch_size], batch_size)
            host = torch.from_numpy(np.ascontiguousarray(chunk))
            if device.type == "cuda":
                # Pinned, so the copy is queued and the host moves on to
                # enqueue the next batch.
                host = host.pin_memory()
            batch = host.to(device, non_blocking=True)
        yield n, batch


class CandidateSearch:
    """The candidate search over one dictionary, on one device or a mesh
    (row-sharded, `parallel.sharded_cosine_topk_inner`): the table cast or
    quantized once, and the engine; ``engine``, ``search_dtype`` and
    ``recall_target`` as `IndexPipeline`'s. Called with ``(B, D)`` device
    queries of any scale and ``k``, it returns their best-first ``(scores,
    indices)``."""

    def __init__(
        self,
        dictionary_vectors,
        device: torch.device,
        engine: str = "exact",
        search_dtype: str = "float32",
        recall_target: float = 0.95,
        mesh=None,
    ) -> None:
        if engine not in ("exact", "fused", "approx", "int8"):
            raise ValueError(f"unknown engine {engine!r}")
        if search_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown search_dtype {search_dtype!r}")
        if isinstance(dictionary_vectors, torch.Tensor):
            # Taken in its dtype (a bf16 table stays bf16), without a host copy.
            vectors = dictionary_vectors if mesh is not None else dictionary_vectors.to(device)
        elif mesh is not None:
            # A host table stays on the host until each shard is copied
            # straight to its own device.
            vectors = np.asarray(dictionary_vectors, np.float32)
        else:
            vectors = torch.as_tensor(np.asarray(dictionary_vectors, np.float32), device=device)
        self.n = len(vectors)
        if engine == "int8":
            vectors = quantize_dictionary_int8(vectors)[0]
        elif search_dtype == "bfloat16" and engine in ("exact", "approx"):
            vectors = (
                torch.from_numpy(vectors).bfloat16()
                if isinstance(vectors, np.ndarray)
                else vectors.to(torch.bfloat16)
            )
        if mesh is not None:
            from latice_tpu_torch.parallel.sharded_knn import shard_dictionary

            self.table = shard_dictionary(vectors, mesh)
        elif engine == "int8":
            # Zero rows up to a multiple of 8 for the int8 tensor cores;
            # the search reads the first n columns of its products.
            self.table = pad_rows(vectors).contiguous()
        else:
            self.table = vectors.contiguous()
        self.engine = engine
        self.recall_target = recall_target
        self.mesh = mesh

    def __call__(self, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            from latice_tpu_torch.parallel.sharded_knn import sharded_cosine_topk_inner

            return sharded_cosine_topk_inner(
                queries, self.table, k, self.mesh, n_valid=self.n,
                engine=self.engine, recall_target=self.recall_target,
            )
        if self.engine == "fused":
            return cosine_topk_fused(queries, self.table, k)
        if self.engine == "int8":
            return cosine_topk_int8(queries, self.table, k, n_valid=self.n)
        q = l2_normalize(queries.float())
        if self.table.dtype == torch.bfloat16:
            q = q.bfloat16()  # both operands rounded; products and sums in f32
            if self.engine == "exact":
                return cosine_topk_wide(q, self.table, k)
        scores = cosine_scores(q, self.table)
        if self.engine == "approx":
            return approx_topk(scores, k, self.recall_target)
        return topk_lower_index_first(scores, k)


class CandidateConsensus:
    """The consensus stage over one dictionary's orientations, on one device.

    Holds the rows' unit quaternions (from their zxz Euler degrees; with
    phases, the phase id rides as a 5th column so one row gather fetches
    both) and each phase's symmetry table (cubic unless named), on the
    device. Called with a batch's best-first ``(B, k)`` candidate scores and
    dictionary rows, it returns the batch's device `ConsensusResult`: the
    consensus mean, the best orientation (the top-1 on failure), success,
    the count of similar candidates and their mask, the indices and scores,
    and with phases the phase (`ops.candidate_consensus_fused`: one kernel
    launch on the card, its plain twin on the CPU). The knobs are
    `IndexPipeline`'s.
    """

    def __init__(
        self,
        dictionary_orientations,
        device: torch.device,
        dictionary_phases=None,
        phase_symmetries=None,
        orientation_threshold: float = 3.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
        angle_unit: str = "deg",
        consensus_weight_power: float | None = None,
    ) -> None:
        quats = from_euler_zxz_deg(
            torch.as_tensor(np.asarray(dictionary_orientations, np.float32), device=device)
        )
        groups = ["432"]
        self.n_phases = None
        if dictionary_phases is not None:
            n = len(quats)
            phases = np.asarray(dictionary_phases, np.int32)
            if phases.shape != (n,):
                raise ValueError(f"dictionary_phases must be ({n},), got {phases.shape}")
            self.n_phases = int(phases.max()) + 1 if n else 1
            if phase_symmetries is None:
                phase_symmetries = ["432"] * self.n_phases
            if len(phase_symmetries) < self.n_phases:
                raise ValueError(
                    f"{self.n_phases} phase ids but only "
                    f"{len(phase_symmetries)} phase_symmetries entries"
                )
            groups = phase_symmetries
            phase_col = torch.as_tensor(phases, dtype=torch.float32, device=device)
            quats = torch.cat([quats, phase_col[:, None]], dim=1)
        # On the device once, so that no call copies a table there.
        self.sym_tables = stack_symmetry_tables(groups, device=device)
        self.quats = quats
        self.threshold = orientation_threshold
        self.min_matches = min_required_matches
        self.max_iterations = max_iterations
        self.angle_unit = angle_unit
        self.weight_power = consensus_weight_power

    def with_knobs(self, orientation_threshold: float, min_required_matches: int,
                   max_iterations: int) -> CandidateConsensus:
        """This stage with other trial knobs, over the same device tables."""
        other = copy.copy(self)
        other.threshold, other.min_matches = orientation_threshold, min_required_matches
        other.max_iterations = max_iterations
        return other

    def __call__(self, scores: torch.Tensor, indices: torch.Tensor) -> ConsensusResult:
        with span("index:consensus"):
            return candidate_consensus_fused(
                scores,
                indices,
                self.quats,
                self.sym_tables,
                self.threshold,
                self.min_matches,
                self.max_iterations,
                angle_unit=self.angle_unit,
                weight_power=self.weight_power,
            )


def collect_results(pending, k: int, multiphase: bool) -> DenseIndexResult:
    """One `DenseIndexResult` from ``(n_real, ConsensusResult)`` per batch,
    copied to the host only here, so every batch is enqueued before the
    first copy."""
    with span("index:collect"):
        if not pending:
            return DenseIndexResult(
                mean_orientation=np.zeros((0, 3), np.float64),
                best_orientation=np.zeros((0, 3), np.float64),
                success=np.zeros((0,), bool),
                n_similar=np.zeros((0,), np.int64),
                indices=np.zeros((0, k), np.int64),
                scores=np.zeros((0, k), np.float64),
                phase=np.zeros((0,), np.int64) if multiphase else None,
            )
        fields = ("mean_euler", "best", "success", "n_similar", "indices", "scores")
        if multiphase:
            fields += ("phase",)
        mean, best, success, n_sim, indices, scores, *phase = (
            np.concatenate([getattr(res, f)[:n].cpu().numpy() for n, res in pending])
            for f in fields
        )
        return DenseIndexResult(
            mean_orientation=np.where(success[:, None], mean, np.nan).astype(np.float64),
            best_orientation=best.astype(np.float64),
            success=success.astype(bool),
            n_similar=n_sim.astype(np.int64),
            indices=indices.astype(np.int64),
            scores=scores.astype(np.float64),
            phase=phase[0].astype(np.int64) if phase else None,
        )
