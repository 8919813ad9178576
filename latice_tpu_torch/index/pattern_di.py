"""Pattern-space dictionary indexing (DI): NCC against raw patterns.

The port of ``latice_tpu.index.pattern_di``, the classic dictionary
indexing baseline (the role of EMsoft's EMDI): an experimental pattern is
indexed by normalized cross-correlation (NCC) against every simulated
dictionary pattern, with no trained encoder. It closes the native loop
``cli.index sample`` → ``simulate`` → ``di`` and is the accuracy yardstick
of the latent pipeline: the same dictionary and consensus, with the
features swapped from 16-d latents to the pixels themselves.

Zero-mean and L2-normalized rows turn NCC into cosine similarity, so the
search is the latent engines' machinery with ``D = H*W / bin²`` features
(`IndexPipeline(feature_fn=...)`): batching and padding, multi-phase
dictionaries, ``preprocess=`` and the exact, approx and int8 engines carry
over unchanged. The fused engine is refused: its kernel keeps a narrow
feature axis per tile (the JAX package refuses it for its VMEM tiles). On
the card the exact engine over the default bf16 table runs one kernel a
batch, K5 (`ops.cosine_topk_wide`), which never forms the f32 table or the
score matrix; the f32 table, the mesh and `StreamedPatternDI` keep the
`index.knn` engines.

NCC is invariant to a per-pattern gain and offset, so uint8 frames need no
/255; only structured corrections (hot pixels, static backgrounds) change
the ranking, and those run through ``preprocess=`` before the features.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.index.knn import cosine_topk_streamed
from latice_tpu_torch.index.pipeline import (
    CandidateConsensus,
    DenseIndexResult,
    IndexPipeline,
    as_preprocess_fn,
    collect_results,
    device_batches,
    model_units,
)
from latice_tpu_torch.parallel.mesh import chunk_device

__all__ = [
    "PatternDictionaryIndexer",
    "StreamedPatternDI",
    "build_pattern_dictionary",
    "ncc_feature_fn",
]


def ncc_feature_fn(bin_factor: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """A ``(B, H, W) -> (B, D)`` NCC feature map: mean-pools by
    ``bin_factor``, flattens, removes each row's mean and L2-normalizes it
    (norm floored at 1e-12), so the dot product of two rows is their NCC."""
    if bin_factor < 1:
        raise ValueError(f"bin_factor must be >= 1, got {bin_factor}")

    def fn(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if bin_factor > 1:
            b, h, w = x.shape
            if h % bin_factor or w % bin_factor:
                raise ValueError(f"bin_factor {bin_factor} does not divide {h}x{w}")
            x = x.reshape(b, h // bin_factor, bin_factor, w // bin_factor, bin_factor).mean(
                dim=(2, 4)
            )
        v = x.reshape(x.shape[0], -1)
        v = v - v.mean(dim=1, keepdim=True)
        norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        return v / torch.clamp(norm, min=1e-12)

    return fn


def build_pattern_dictionary(
    patterns,
    bin_factor: int = 1,
    batch_size: int = 512,
    preprocess: Any = None,
    as_numpy: bool = True,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
):
    """NCC feature rows of a dictionary pattern stack, computed on the device.

    Args:
        patterns: ``(N, H, W)`` or ``(N, H, W, 1)`` stack, any real dtype
            (uint8 `simulate` output included), host numpy or a tensor.
        bin_factor: mean-pool factor applied before flattening.
        batch_size: patterns per device batch.
        preprocess: optional correction of the ``(B, H, W)`` float32 batch
            (a callable or a `data.PreprocessConfig`), after the uint8 /255
            as in `IndexPipeline`; it must match the queries' correction.
        as_numpy: rows on the host, each batch copied back as it is done
            (for `StreamedPatternDI` or to persist); False keeps them on the
            device, which skips the round trip.
        dtype: ``torch.float32`` or ``torch.bfloat16`` (half the residency).
        device: where the features are computed, ``cuda`` unless given
            (tensor input too); a missing CUDA device raises.

    Returns:
        ``(N, D)`` unit-norm, zero-mean rows: numpy with ``as_numpy`` (a CPU
        tensor for bf16, which numpy has no type for), else a device tensor.
    """
    dev = resolve_device(device)
    x = patterns if isinstance(patterns, torch.Tensor) else np.asarray(patterns)
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.ndim != 3:
        raise ValueError(f"expected (N, H, W) or (N, H, W, 1) patterns, got {tuple(x.shape)}")
    preprocess = as_preprocess_fn(preprocess)
    feature = ncc_feature_fn(bin_factor)
    rows = None
    with torch.no_grad():
        for start in range(0, len(x), batch_size):
            chunk = x[start : start + batch_size]
            if not isinstance(chunk, torch.Tensor):
                chunk = torch.from_numpy(np.ascontiguousarray(chunk))
            f = feature(model_units(chunk.to(dev), preprocess)).to(dtype)
            if rows is None:
                rows = torch.empty((len(x), f.shape[1]), dtype=dtype,
                                   device="cpu" if as_numpy else dev)
            rows[start : start + len(f)] = f
    if rows is None:
        raise ValueError("empty pattern stack")
    if as_numpy and dtype != torch.bfloat16:
        return rows.numpy()
    return rows


class PatternDictionaryIndexer:
    """Brute-force NCC dictionary indexer over raw patterns: a thin assembly
    over `IndexPipeline(feature_fn=...)`, called like a pipeline, returning a
    `DenseIndexResult` whose ``scores`` are NCC values.

    Args:
        dictionary_patterns: ``(N, H, W[, 1])`` dictionary stack (`simulate`
            output), or precomputed ``(N, D)`` rows from
            `build_pattern_dictionary` (pass the same ``bin_factor``).
        dictionary_orientations: ``(N, 3)`` zxz Euler degrees.
        bin_factor: mean-pool factor for dictionary and queries.
        engine: "exact" (default), "approx" or "int8" (`IndexPipeline`);
            "fused" is refused.
        search_dtype: "bfloat16" (default: the table in bf16, products in
            f32) or "float32".
        preprocess: optional correction of the queries only (raw detector
            frames toward the ideal space of a simulated dictionary).
        dict_preprocess: optional correction of the dictionary stack
            (ignored for precomputed rows).
        dict_batch_size: patterns per batch of the dictionary build.
        Everything else (top_n, orientation_threshold,
        min_required_matches, batch_size, device, mesh, dictionary_phases,
        phase_symmetries, consensus_weight_power, ...) goes to
        `IndexPipeline` unchanged; with ``mesh`` the queries shard by batch
        and the feature rows by row.
    """

    def __init__(
        self,
        dictionary_patterns,
        dictionary_orientations,
        bin_factor: int = 1,
        engine: str = "exact",
        search_dtype: str = "bfloat16",
        preprocess: Any = None,
        dict_preprocess: Any = None,
        dict_batch_size: int = 512,
        **pipeline_kw: Any,
    ) -> None:
        if engine == "fused":
            raise ValueError(
                "pattern DI cannot use the fused engine: its kernel assumes a "
                "narrow feature axis (use exact/approx/int8)"
            )
        pats = dictionary_patterns
        if not isinstance(pats, torch.Tensor):
            pats = np.asarray(pats)
        if pats.ndim == 2:
            vectors = pats  # precomputed rows (host or device)
        else:
            # Built in the engine's dtype on the device: an f32 table at
            # unbinned sizes is twice the bf16 one. With a mesh the rows go
            # back to the host, and each shard is copied from there to its
            # own device (a build kept on the first device would hold the
            # whole table there).
            mesh = pipeline_kw.get("mesh")
            vectors = build_pattern_dictionary(
                pats,
                bin_factor=bin_factor,
                batch_size=dict_batch_size,
                preprocess=dict_preprocess,
                as_numpy=mesh is not None,
                dtype=torch.bfloat16
                if search_dtype == "bfloat16" and engine != "int8"
                else torch.float32,
                device=chunk_device(mesh, pipeline_kw.get("device")),
            )
        self.bin_factor = bin_factor
        self.pipeline = IndexPipeline(
            None,
            vectors,
            dictionary_orientations,
            engine=engine,
            search_dtype=search_dtype,
            preprocess=preprocess,
            feature_fn=ncc_feature_fn(bin_factor),
            **pipeline_kw,
        )

    def __call__(self, patterns: np.ndarray) -> DenseIndexResult:
        return self.pipeline(patterns)

    @property
    def batch_size(self) -> int:
        return self.pipeline.batch_size

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    @property
    def engine(self) -> str:
        return self.pipeline.engine

    @property
    def dimension(self) -> int:
        """Features per row: ``H*W / bin_factor**2``."""
        return int(self.pipeline.search.table.shape[1])


class StreamedPatternDI:
    """Pattern DI over dictionaries beyond device memory.

    The feature rows stay in host RAM (or an ``np.memmap``) and stream
    through the device in fixed chunks with a running top-k merge
    (`index.knn.cosine_topk_streamed`), so the device holds O(chunk x D)
    whatever N is. Each query batch makes one pass over the rows: use a
    large ``batch_size``. The features, the search's scores and the
    consensus (`CandidateConsensus`, multi-phase and
    ``consensus_weight_power`` included) are the resident indexer's, so
    the results equal `PatternDictionaryIndexer`'s over the same rows.

    Args:
        dictionary_rows: ``(N, D)`` host rows from
            `build_pattern_dictionary(..., as_numpy=True)` (f32 numpy, or a
            bf16 CPU tensor), or any L2-normalized table.
        dictionary_orientations: ``(N, 3)`` zxz Euler degrees.
        bin_factor: the build's.
        chunk_rows: dictionary rows per transfer.
        top_n / orientation_threshold / min_required_matches /
        max_iterations: consensus knobs.
        batch_size: query rows per device batch.
        preprocess: optional query correction (see
            `PatternDictionaryIndexer`).
        dictionary_phases / phase_symmetries: multi-phase, as the resident
            engine.
        consensus_weight_power: optional similarity-power consensus weights.
        device: ``cuda`` unless given; a missing CUDA device raises.
    """

    def __init__(
        self,
        dictionary_rows,
        dictionary_orientations,
        bin_factor: int = 1,
        chunk_rows: int = 131072,
        top_n: int = 20,
        orientation_threshold: float = 3.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
        batch_size: int = 1024,
        preprocess: Any = None,
        dictionary_phases=None,
        phase_symmetries=None,
        consensus_weight_power: float | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        if dictionary_rows.ndim != 2:
            raise ValueError(
                "StreamedPatternDI takes precomputed (N, D) feature rows "
                "(build_pattern_dictionary(..., as_numpy=True)); got "
                f"shape {tuple(dictionary_rows.shape)}"
            )
        self.device = resolve_device(device)
        self.rows = dictionary_rows
        n = len(dictionary_rows)
        if len(dictionary_orientations) != n:
            raise ValueError(f"{n} rows vs {len(dictionary_orientations)} angles")
        self.chunk_rows = chunk_rows
        self.batch_size = batch_size
        self.k = min(top_n, n)
        self.consensus = CandidateConsensus(
            dictionary_orientations,
            self.device,
            dictionary_phases=dictionary_phases,
            phase_symmetries=phase_symmetries,
            orientation_threshold=orientation_threshold,
            min_required_matches=min_required_matches,
            max_iterations=min(max_iterations, self.k),
            consensus_weight_power=consensus_weight_power,
        )
        self._preprocess = as_preprocess_fn(preprocess)
        self._feature = ncc_feature_fn(bin_factor)

    @torch.inference_mode()
    def __call__(self, patterns: np.ndarray) -> DenseIndexResult:
        pending = []
        for n, chunk in device_batches(patterns, self.batch_size, self.device):
            feats = self._feature(model_units(chunk, self._preprocess))
            scores, indices = cosine_topk_streamed(feats, self.rows, self.k, self.chunk_rows)
            pending.append((n, self.consensus(scores, indices)))
        return collect_results(pending, self.k, self.consensus.n_phases is not None)
