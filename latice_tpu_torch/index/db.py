"""Latent-vector database: the dictionary a server searches, on the host.

The port of what serving needs from ``latice_tpu.index.db``: vectors
(L2-normalized at add time), zxz-degree orientations and optional phase
ids, persisted in the same single ``.npz`` (keys ``vectors``,
``orientations``, ``phases``, ``phase_groups``), so a file written by
``latice_tpu``'s ``index.py build`` loads unchanged, and so does one written
by the reference FAISS backend (a serialized ``IndexFlat`` under
``faiss_index``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["LatentVectorDatabaseConfig", "TorchLatentVectorDatabase", "parse_faiss_flat_blob"]


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


@dataclass
class LatentVectorDatabaseConfig:
    """Where the database persists and its latent width.

    ``phase_symmetries`` names one point group per phase id of a
    multi-phase dictionary (cubic "432" for every phase when None).
    """

    npz_path: str = "latent_index.npz"
    dimension: int = 16
    phase_symmetries: Any = None


class TorchLatentVectorDatabase:
    """Host-side latent dictionary with ``.npz`` persistence.

    Loads ``npz_path`` at construction when the file exists. The vectors
    go to the device when a pipeline is built over them.
    """

    def __init__(self, config: LatentVectorDatabaseConfig | None = None) -> None:
        self.config = config if config is not None else LatentVectorDatabaseConfig()
        self.dimension = self.config.dimension
        self.npz_path = Path(self.config.npz_path)
        self._vectors = np.zeros((0, self.dimension), dtype=np.float32)
        self._orientations = np.zeros((0, 3), dtype=np.float64)
        self._phases = np.zeros((0,), dtype=np.int32)
        self._has_phases = False
        if self.npz_path.with_suffix(".npz").exists():
            self.load()

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

    def get_count(self) -> int:
        return len(self._vectors)

    def save(self) -> None:
        """Write vectors + orientations (+ phases) to the ``.npz``."""
        path = self.npz_path.with_suffix(".npz")
        extra = {}
        if self._has_phases:
            extra["phases"] = self._phases
            if self.config.phase_symmetries is not None:
                extra["phase_groups"] = np.asarray(
                    list(self.config.phase_symmetries), dtype=np.str_
                )
        np.savez_compressed(
            str(path), vectors=self._vectors, orientations=self._orientations, **extra
        )
        logger.info(f"Saved index to {path}")

    def load(self) -> None:
        """Read the ``.npz``: this format or the reference FAISS backend's."""
        path = self.npz_path.with_suffix(".npz")
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
        self.dimension = self._vectors.shape[1]
        logger.info(f"Loaded index from {path}")
