"""The FAISS backend's names over the port's database.

For users of the reference's ``latice.index.faiss_db``: the same class and
config names and semantics (exact cosine search, misorientation thresholds
in degrees, one ``.npz``), run by `index.db.TorchLatentVectorDatabase`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from latice_tpu_torch.index.db import (
    LatentVectorDatabaseConfig as _TorchConfig,
    TorchLatentVectorDatabase,
    parse_faiss_flat_blob,
)
from latice_tpu_torch.index.result import OrientationResult

__all__ = [
    "FaissLatentVectorDatabase",
    "FaissLatentVectorDatabaseConfig",
    "OrientationResult",
    "parse_faiss_flat_blob",
]


@dataclass
class FaissLatentVectorDatabaseConfig:
    """The reference's config (faiss_db.py:34-46): npz path and dimension.
    Only exact (flat) cosine search exists, as in the reference."""

    npz_path: str = "faiss_index.npz"
    dimension: int = 16


class FaissLatentVectorDatabase(TorchLatentVectorDatabase):
    """Reference-named exact-cosine database (faiss_db.py:92) with degree
    thresholds; ``device`` is where queries run (``cuda`` unless given)."""

    def __init__(
        self,
        config: FaissLatentVectorDatabaseConfig | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        cfg = config if config is not None else FaissLatentVectorDatabaseConfig()
        super().__init__(
            _TorchConfig(npz_path=cfg.npz_path, dimension=cfg.dimension, angle_unit="deg"),
            device=device,
        )
