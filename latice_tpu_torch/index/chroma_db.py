"""The ChromaDB backend's names and behaviours over the port's database.

For users of the reference's ``latice.index.chroma_db``:

* ``query_similar`` returns a chroma-style dict with each candidate's
  orientation metadata and **cosine distances** (1 - similarity, the
  metric of a ``{"hnsw:space": "cosine"}`` collection, chroma_db.py:129);
* ``find_best_orientation`` thresholds misorientation **in radians**
  (chroma_db.py:307-310) and keeps ``best_orientation`` as the closest
  match even on success (chroma_db.py:299 never reassigns it);
* persistence under ``persist_directory`` keyed by ``collection_name``,
  with ``delete_collection()``.

The search is exact, run by `index.db.TorchLatentVectorDatabase`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from latice_tpu_torch.index.db import (
    LatentVectorDatabaseConfig as _TorchConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.index.result import OrientationResult

logger = logging.getLogger(__name__)

__all__ = ["ChromaLatentVectorDatabase", "LatentVectorDatabaseConfig", "OrientationResult"]


@dataclass
class LatentVectorDatabaseConfig:
    """The reference's config (chroma_db.py:25-39)."""

    collection_name: str = "latent_vectors"
    dimension: int = 16
    persist_directory: str | None = None


class ChromaLatentVectorDatabase(TorchLatentVectorDatabase):
    """Reference-named database with the chroma backend's semantics
    (chroma_db.py:87); ``device`` is where queries run (``cuda`` unless
    given)."""

    def __init__(
        self,
        config: LatentVectorDatabaseConfig | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.chroma_config = config if config is not None else LatentVectorDatabaseConfig()
        self.collection_name = self.chroma_config.collection_name
        self.persist_directory = self.chroma_config.persist_directory
        if self.persist_directory:
            persist_path = Path(self.persist_directory)
            persist_path.mkdir(exist_ok=True, parents=True)
            npz_path = str(persist_path / f"{self.collection_name}.npz")
        else:
            # In memory: a path that exists only if saved to.
            npz_path = f"{self.collection_name}.npz"
        super().__init__(
            _TorchConfig(
                npz_path=npz_path, dimension=self.chroma_config.dimension, angle_unit="rad"
            ),
            device=device,
        )

    def add_vectors(self, latent_vectors, orientations, batch_size: int = 1000) -> None:
        """Add vectors; ``batch_size`` is accepted for the reference's
        signature. Saves when a ``persist_directory`` was configured."""
        super().add_vectors(latent_vectors, orientations)
        if self.persist_directory:
            self.save()

    def query_similar(
        self, query_vector, n_results: int = 20, include_metadata: bool = True
    ) -> dict[str, Any]:
        """Chroma-style results: ``ids``, ``distances`` (1 - similarity)
        and, with ``include_metadata``, ``metadatas`` holding each
        candidate's ``phi1``/``Phi``/``phi2``."""
        query_vector = np.asarray(query_vector)
        if query_vector.ndim > 1:
            query_vector = query_vector.squeeze()
        if query_vector.shape[0] != self.dimension:
            raise ValueError(
                f"Expected query vector of dimension {self.dimension}, "
                f"got {query_vector.shape[0]}"
            )
        sims, indices = TorchLatentVectorDatabase.query_similar(self, query_vector, n_results)
        results: dict[str, Any] = {
            "ids": [[f"vec_{i}" for i in indices]],
            "distances": [list(1.0 - sims)],
        }
        if include_metadata:
            results["metadatas"] = [
                [
                    {
                        "orientation_str": ",".join(map(str, self._orientations[i])),
                        "phi1": float(self._orientations[i][0]),
                        "Phi": float(self._orientations[i][1]),
                        "phi2": float(self._orientations[i][2]),
                    }
                    for i in indices
                ]
            ]
        return results

    def find_best_orientations_batch(
        self, query_vectors, batch_size: int | None = None, **kwargs: Any
    ) -> list[OrientationResult]:
        """Batch consensus with the chroma post-processing: the closest
        match as ``best_orientation`` and cosine distances. The inherited
        single-query method goes through here."""
        results = TorchLatentVectorDatabase.find_best_orientations_batch(
            self, query_vectors, batch_size=batch_size, **kwargs
        )
        for result in results:
            if len(result.candidate_orientations):
                result.best_orientation = result.candidate_orientations[0]
            if result.distances is not None and len(result.distances):
                result.distances = 1.0 - result.distances
        return results

    def delete_collection(self) -> None:
        """Drop the collection and its file (chroma_db.py:420-423)."""
        self.delete_persistence()
        logger.info(f"Deleted collection '{self.collection_name}'")
