"""Latent-vector database: exact cosine search and orientation consensus.

The port of ``latice_tpu.index.db``. The host keeps the vectors
(L2-normalized at add time), the zxz-degree orientations and optional phase
ids, persisted in one ``.npz`` (keys ``vectors``, ``orientations``,
``phases``, ``phase_groups``, ``sim_meta``), so a file written by
``latice_tpu``'s ``index.py build`` loads unchanged, and so does one written
by the reference FAISS backend (a serialized ``IndexFlat`` under
``faiss_index``). Queries go through `IndexPipeline`'s two stages, built
over the dictionary on the device at the first query: the top-k
(`index.pipeline.CandidateSearch`, or the host C++ engine for "native") and
the batched consensus (`index.pipeline.CandidateConsensus`: on the card the
kernel `ops.candidate_consensus_fused`, one launch a chunk).
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from latice_tpu_torch.device import resolve_device
from latice_tpu_torch.index.pipeline import CandidateConsensus, CandidateSearch
from latice_tpu_torch.index.result import OrientationResult

logger = logging.getLogger(__name__)

__all__ = [
    "LatentVectorDatabaseBase",
    "LatentVectorDatabaseConfig",
    "OrientationResult",
    "TorchLatentVectorDatabase",
    "parse_faiss_flat_blob",
]

# The database's engine names and `CandidateSearch`'s ("native" searches on the host).
_SEARCH_ENGINES = {"device": "exact", "fused": "fused", "approx": "approx", "int8": "int8",
                   "native": None}


def _l2_normalize_np(vectors: np.ndarray) -> np.ndarray:
    """Row normalization; zero rows stay zero."""
    norms = np.linalg.norm(vectors, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return vectors / norms


def parse_faiss_flat_blob(blob: bytes | np.ndarray) -> np.ndarray:
    """Decode a serialized FAISS ``IndexFlat`` into its ``(ntotal, d)`` vectors.

    Reads the byte stream ``faiss.serialize_index`` emits for flat indexes
    without faiss: fourcc ``IxFI``/``IxF2``/``IxFl``, ``d`` int32, ``ntotal``
    int64, then the vectors as a length-prefixed float32 vector at the end
    of the stream. The data is located from the tail, so header-size drift
    between faiss versions cannot misalign it; the length prefix is checked
    in both the float-count and byte-count conventions.
    """
    if isinstance(blob, (bytes, bytearray, memoryview)):
        raw = bytes(blob)
    else:
        raw = np.asarray(blob).astype(np.uint8, copy=False).tobytes()
    if len(raw) < 45:
        raise ValueError("serialized FAISS index too short to be an IndexFlat")
    fourcc = raw[:4]
    if fourcc not in (b"IxFI", b"IxF2", b"IxFl"):
        raise ValueError(
            f"unsupported FAISS index type {fourcc!r}: only flat indexes "
            "(IndexFlat / IndexFlatIP / IndexFlatL2) can be parsed"
        )
    d = int(np.frombuffer(raw, dtype="<i4", count=1, offset=4)[0])
    ntotal = int(np.frombuffer(raw, dtype="<i8", count=1, offset=8)[0])
    if d <= 0 or ntotal < 0:
        raise ValueError(f"implausible FAISS header: d={d}, ntotal={ntotal}")
    nbytes = ntotal * d * 4
    if len(raw) < nbytes + 8:
        raise ValueError("serialized FAISS index truncated")
    prefix = int(np.frombuffer(raw, dtype="<u8", count=1, offset=len(raw) - nbytes - 8)[0])
    if prefix not in (ntotal * d, nbytes):
        raise ValueError(
            f"FAISS data-vector length prefix {prefix} does not match ntotal*d={ntotal * d}"
        )
    vectors = np.frombuffer(raw, dtype="<f4", count=ntotal * d, offset=len(raw) - nbytes)
    return vectors.reshape(ntotal, d).copy()


class LatentVectorDatabaseBase(ABC):
    """The latent-vector database contract of the reference's two backends
    (chroma_db.py:87, faiss_db.py:92), whose base class module the
    reference imports but does not ship."""

    @abstractmethod
    def add_vectors(self, latent_vectors, orientations) -> None: ...

    @abstractmethod
    def create_from_files(self, latent_file_path, angles_file_path) -> None: ...

    @abstractmethod
    def query_similar(self, query_vector, n_results: int = 20): ...

    @abstractmethod
    def find_best_orientation(
        self,
        query_vector,
        top_n: int = 20,
        orientation_threshold: float = 1.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
    ) -> OrientationResult: ...

    @abstractmethod
    def find_best_orientations_batch(
        self, query_vectors, batch_size: int = 32, **kwargs
    ) -> list[OrientationResult]: ...

    @abstractmethod
    def get_count(self) -> int: ...


@dataclass
class LatentVectorDatabaseConfig:
    """Configuration of `TorchLatentVectorDatabase`.

    Attributes:
        npz_path: the single-file persistence target.
        dimension: latent width (16 in the reference).
        angle_unit: "deg" thresholds misorientation in degrees (the FAISS
            backend); "rad" keeps the chroma backend's radians.
        device_batch_size: most queries per device batch in the batch APIs.
        engine: "device" (`index.pipeline.CandidateSearch`'s "exact":
            matmul and top-k), "fused", "approx" (recall target 0.95) or
            "int8" (the dictionary quantized once), as that stage runs
            them, or "native" (the host C++ engine,
            `native.cosine_topk_native`; ``ImportError`` when the library
            cannot be built).
        phase_symmetries: point-group names, one per phase id of a
            multi-phase dictionary (cubic "432" for every phase when None).
    """

    npz_path: str = "latent_index.npz"
    dimension: int = 16
    angle_unit: str = "deg"
    device_batch_size: int = 4096
    engine: str = "device"
    phase_symmetries: Any = None


class TorchLatentVectorDatabase(LatentVectorDatabaseBase):
    """Exact-search latent dictionary: metadata on the host, the search and
    the consensus on ``device``.

    Loads ``npz_path`` at construction when the file exists. ``device`` is
    where queries run, ``cuda`` unless given; it is resolved at the first
    query, so building, saving and loading need no device. The search and
    consensus stages over the dictionary are built on the device at the
    first query and dropped when the dictionary changes.
    """

    def __init__(
        self,
        config: LatentVectorDatabaseConfig | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.config = config if config is not None else LatentVectorDatabaseConfig()
        if self.config.engine not in _SEARCH_ENGINES:
            raise ValueError(f"unknown engine {self.config.engine!r}")
        self.dimension = self.config.dimension
        self.npz_path = Path(self.config.npz_path)
        self._device_arg = device
        self._vectors = np.zeros((0, self.dimension), dtype=np.float32)
        self._orientations = np.zeros((0, 3), dtype=np.float64)
        self._phases = np.zeros((0,), dtype=np.int32)
        self._has_phases = False
        self.sim_meta: dict | None = None
        self._stages: tuple[CandidateSearch | None, CandidateConsensus] | None = None
        if self.npz_path.with_suffix(".npz").exists():
            self.load()
        else:
            logger.info(f"No existing index found at {self.npz_path}. Creating a new one.")

    # -- mutation ----------------------------------------------------------

    def _invalidate(self) -> None:
        self._stages = None

    def add_vectors(self, latent_vectors, orientations, phases=None) -> None:
        """Add vectors (normalized here) with their orientations and,
        optionally, phase ids; entries added without phases get phase 0."""
        vecs = np.asarray(latent_vectors, dtype=np.float32)
        orients = np.asarray(orientations, dtype=np.float64)
        if len(vecs) != len(orients):
            raise ValueError("Number of latent vectors and orientations must match")
        if vecs.ndim != 2 or vecs.shape[1] != self.dimension:
            raise ValueError(
                f"Expected latent vectors of dimension {self.dimension}, got {vecs.shape}"
            )
        if orients.ndim != 2 or orients.shape[1] != 3:
            raise ValueError(f"Expected orientations of shape (n, 3), got {orients.shape}")
        if phases is not None:
            ph = np.asarray(phases, dtype=np.int32).reshape(-1)
            if len(ph) != len(vecs):
                raise ValueError("Number of phases and latent vectors must match")
            self._has_phases = True
        else:
            ph = np.zeros(len(vecs), dtype=np.int32)
        self._vectors = np.concatenate([self._vectors, _l2_normalize_np(vecs)])
        self._orientations = np.concatenate([self._orientations, orients])
        self._phases = np.concatenate([self._phases, ph])
        self._invalidate()
        logger.info(f"Added {len(vecs)} vectors. Index total: {self.get_count()}")

    def create_from_files(self, latent_file_path, angles_file_path) -> None:
        """Build from ``.npy`` latent and angle files, then save."""
        latent_vectors = np.load(Path(latent_file_path)).astype(np.float32)
        orientations = np.load(Path(angles_file_path))
        self.add_vectors(latent_vectors, orientations)
        self.save()

    # -- device state ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """Where queries run (``cuda`` unless the constructor was given
        another device; a missing CUDA device raises)."""
        return resolve_device(self._device_arg)

    def _device_stages(self) -> tuple[CandidateSearch | None, CandidateConsensus]:
        """The search stage (None for the host engine) and the consensus
        stage over this dictionary on the device, built once."""
        if self._stages is None:
            engine = _SEARCH_ENGINES[self.config.engine]
            search = None if engine is None else CandidateSearch(
                self._vectors, self.device, engine=engine)
            consensus = CandidateConsensus(
                self._orientations, self.device,
                dictionary_phases=self._phases if self._has_phases else None,
                phase_symmetries=self.config.phase_symmetries, angle_unit=self.config.angle_unit,
            )
            self._stages = (search, consensus)
        return self._stages

    # -- queries -----------------------------------------------------------

    def query_similar(self, query_vector, n_results: int = 20) -> tuple[np.ndarray, np.ndarray]:
        """Top-k cosine search for one query: ``(similarities, indices)``,
        empty arrays on an empty index."""
        scores, indices = self.query_similar_batch(
            np.atleast_2d(np.asarray(query_vector)), n_results
        )
        if scores.size == 0:
            return np.array([]), np.array([])
        return scores[0], indices[0]

    def query_similar_batch(
        self, query_vectors, n_results: int = 20
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k cosine search: ``(B, k)`` f64 scores and int64
        indices; ``k`` is cut to the index size, with a warning."""
        count = self.get_count()
        if count == 0:
            logger.warning("Querying an empty index.")
            return np.zeros((0, 0)), np.zeros((0, 0), dtype=np.int64)
        if count < n_results:
            logger.warning(
                f"Requested {n_results} results, but index only contains "
                f"{count} vectors. Returning all."
            )
            n_results = count
        queries = np.asarray(query_vectors, dtype=np.float32)
        if queries.shape[1] != self.dimension:
            raise ValueError(
                f"Expected query vector of dimension {self.dimension}, got {queries.shape[1]}"
            )
        scores, indices = self._topk(queries, n_results)
        return scores.cpu().double().numpy(), indices.cpu().numpy()

    @torch.inference_mode()
    def _topk(self, queries: np.ndarray, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k of host queries with the configured engine: on the device,
        or on the host CPU for ``native``."""
        if self.config.engine == "native":
            from latice_tpu_torch.native import cosine_topk_native

            scores, indices = cosine_topk_native(queries, self._vectors, k)
            return torch.from_numpy(scores), torch.from_numpy(indices)
        search, _ = self._device_stages()
        return search(torch.as_tensor(queries, device=self.device).contiguous(), k)

    @torch.inference_mode()
    def _consensus(self, queries, batch_size, top_n, orientation_threshold, min_required_matches,
                   max_iterations):
        """``(queries, outputs)`` per chunk of ``batch_size`` (default
        ``device_batch_size``): the top-k and the consensus as host arrays
        named as `ConsensusResult`'s fields, ``best`` under the reference
        API's rule: the mean, or where no trial succeeds the top-1
        candidate's stored angles (faiss_db.py:336-343), not their
        canonical form."""
        k = min(top_n, self.get_count())
        _, consensus = self._device_stages()
        consensus = consensus.with_knobs(
            orientation_threshold, min_required_matches, min(max_iterations, k))
        dev = consensus.quats.device
        chunk = max(batch_size or self.config.device_batch_size, 1)
        for start in range(0, len(queries), chunk):
            part = queries[start : start + chunk]
            scores, indices = self._topk(part, k)
            out = consensus(scores.to(dev, torch.float32), indices.to(dev))
            host = {f: None if t is None else t.cpu().numpy()
                    for f, t in out._asdict().items() if f != "best"}
            host["mean_euler"] = host["mean_euler"].astype(np.float64)
            host["scores"] = host["scores"].astype(np.float64)
            host["indices"] = host["indices"].astype(np.int64)
            host["best"] = np.where(host["success"][:, None], host["mean_euler"],
                                    self._orientations[host["indices"][:, 0]])
            yield part, host

    def find_best_orientation(
        self,
        query_vector,
        top_n: int = 20,
        orientation_threshold: float = 1.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
    ) -> OrientationResult:
        """Consensus orientation of one query."""
        return self.find_best_orientations_batch(
            np.atleast_2d(np.asarray(query_vector)),
            top_n=top_n,
            orientation_threshold=orientation_threshold,
            min_required_matches=min_required_matches,
            max_iterations=max_iterations,
        )[0]

    def find_best_orientations_batch(
        self,
        query_vectors,
        batch_size: int | None = None,
        top_n: int = 20,
        orientation_threshold: float = 1.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
        progress: bool = False,
    ) -> list[OrientationResult]:
        """Consensus of many queries, ``batch_size`` (default
        ``device_batch_size``) at a time on the device. ``progress`` is
        accepted and draws nothing in the port."""
        queries = np.asarray(query_vectors, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if self.get_count() == 0:
            logger.warning("No similar vectors found for query.")
            return [self._empty_result(q) for q in queries]
        results = []
        for part, out in self._consensus(queries, batch_size, top_n, orientation_threshold,
                                         min_required_matches, max_iterations):
            for b, query in enumerate(part):
                ok = bool(out["success"][b])
                results.append(OrientationResult(
                    query_vector=query.astype(np.float64),
                    best_orientation=out["best"][b],
                    mean_orientation=out["mean_euler"][b] if ok else None,
                    candidate_orientations=self._orientations[out["indices"][b]],
                    distances=out["scores"][b],
                    success=ok,
                    similar_indices=np.where(out["similar_mask"][b])[0],
                    phase=None if out["phase"] is None else int(out["phase"][b]),
                ))
        return results

    def find_best_orientations_dense(
        self,
        query_vectors,
        top_n: int = 20,
        orientation_threshold: float = 1.0,
        min_required_matches: int = 18,
        max_iterations: int = 3,
        batch_size: int | None = None,
    ) -> dict[str, np.ndarray]:
        """Batch consensus as arrays: ``mean_orientation`` (NaN rows where
        not ``success``), ``best_orientation`` (the mean, or the top-1
        candidate's stored angles), ``success``, ``n_similar``, ``indices``,
        ``scores`` and, for multi-phase dictionaries, ``phase``."""
        queries = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if self.get_count() == 0:
            nan3 = np.full((len(queries), 3), np.nan)
            return {
                "mean_orientation": nan3,
                "best_orientation": nan3.copy(),
                "success": np.zeros(len(queries), bool),
                "n_similar": np.zeros(len(queries), np.int64),
                "indices": np.zeros((len(queries), 0), np.int64),
                "scores": np.zeros((len(queries), 0)),
            }
        outs = [out for _, out in self._consensus(queries, batch_size, top_n, orientation_threshold,
                                                  min_required_matches, max_iterations)]
        cat = {f: np.concatenate([o[f] for o in outs]) for f in outs[0] if outs[0][f] is not None}
        result = {
            "mean_orientation": np.where(cat["success"][:, None], cat["mean_euler"], np.nan),
            "best_orientation": cat["best"],
            "success": cat["success"],
            "n_similar": cat["n_similar"].astype(np.int64),
            "indices": cat["indices"],
            "scores": cat["scores"],
        }
        if self._has_phases:
            result["phase"] = cat["phase"].astype(np.int64)
        return result

    def _empty_result(self, query: np.ndarray) -> OrientationResult:
        """The failed result of a query on an empty index."""
        return OrientationResult(
            query_vector=np.asarray(query).squeeze().astype(np.float64),
            best_orientation=np.array([np.nan, np.nan, np.nan]),
            candidate_orientations=np.array([]),
            distances=np.array([]),
            mean_orientation=None,
            success=False,
            similar_indices=None,
        )

    # -- bookkeeping -------------------------------------------------------

    def get_count(self) -> int:
        return len(self._vectors)

    def save(self) -> None:
        """Write vectors + orientations (+ phases, + ``sim_meta``) to the
        ``.npz``."""
        path = self.npz_path.with_suffix(".npz")
        extra = {}
        if self._has_phases:
            extra["phases"] = self._phases
            if self.config.phase_symmetries is not None:
                extra["phase_groups"] = np.asarray(
                    list(self.config.phase_symmetries), dtype=np.str_
                )
        if self.sim_meta is not None:
            extra["sim_meta"] = np.asarray(json.dumps(self.sim_meta))
        np.savez_compressed(
            str(path), vectors=self._vectors, orientations=self._orientations, **extra
        )
        logger.info(f"Saved index to {path}")

    def load(self) -> None:
        """Read the ``.npz``: this format or the reference FAISS backend's."""
        path = self.npz_path.with_suffix(".npz")
        if not path.exists():
            raise FileNotFoundError(f"NPZ file {path} missing.")
        with np.load(str(path)) as data:
            if "vectors" in data:
                self._vectors = data["vectors"].astype(np.float32)
            elif "faiss_index" in data:
                self._vectors = parse_faiss_flat_blob(data["faiss_index"]).astype(np.float32)
            else:
                raise KeyError(
                    f"{path} holds neither 'vectors' nor 'faiss_index': not a latent-index file"
                )
            self._orientations = data["orientations"].astype(np.float64)
            self._has_phases = "phases" in data
            self._phases = (
                data["phases"].astype(np.int32)
                if self._has_phases
                else np.zeros(len(self._vectors), dtype=np.int32)
            )
            if "phase_groups" in data and self.config.phase_symmetries is None:
                self.config.phase_symmetries = [str(g) for g in data["phase_groups"]]
            self.sim_meta = json.loads(str(data["sim_meta"])) if "sim_meta" in data else None
        self.dimension = self._vectors.shape[1]
        self._invalidate()
        logger.info(f"Loaded index from {path}")

    def delete_persistence(self) -> None:
        """Delete the ``.npz`` and empty the index."""
        path = self.npz_path.with_suffix(".npz")
        try:
            if path.exists():
                path.unlink()
                logger.info(f"Deleted index file: {path}")
                self._vectors = np.zeros((0, self.dimension), dtype=np.float32)
                self._orientations = np.zeros((0, 3), dtype=np.float64)
                self._phases = np.zeros((0,), dtype=np.int32)
                self._has_phases = False
                self._invalidate()
        except OSError as e:
            logger.error(f"Error deleting index file {self.npz_path}: {e}")
