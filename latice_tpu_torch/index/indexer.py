"""Diffraction-pattern indexer: encode patterns, build dictionaries, query.

The port of ``latice_tpu.index.indexer`` (the reference's
``DiffractionPatternIndexer`` and ``IndexerConfig``, dp_indexer.py:26-297).
Encoding runs in fixed-size batches (a partial batch is padded), and a
dictionary build keeps up to four batches in flight: each batch's copy and
encode are enqueued before the oldest result is copied back.
"""

from __future__ import annotations

import contextlib
import logging
from collections import deque
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from typing import Any, Literal

import numpy as np
import torch

from latice_tpu_torch.data import DPDataModule, default_transform
from latice_tpu_torch.index.db import (
    LatentVectorDatabaseBase,
    LatentVectorDatabaseConfig,
    TorchLatentVectorDatabase,
)
from latice_tpu_torch.index.result import OrientationResult
from latice_tpu_torch.parallel.mesh import chunk_device, gather_rows, replicate, shard_batch

logger = logging.getLogger(__name__)

__all__ = ["DiffractionPatternIndexer", "IndexerConfig"]

_WINDOW = 4  # encode batches in flight during a dictionary build


@dataclass
class IndexerConfig:
    """Configuration of the indexer (dp_indexer.py:26-48).

    Attributes:
        pattern_path: the dictionary's ``.npy`` pattern stack.
        angles_path: the dictionary's angle file.
        batch_size: patterns per encode batch.
        device: "cuda" or "cpu"; a missing CUDA device raises.
        latent_dim: latent width.
        random_seed: kept for the reference's signature.
        image_size: pattern size after the default transform.
        top_n: candidates per query.
        orientation_threshold: consensus misorientation threshold, degrees.
    """

    pattern_path: Path | str | None = None
    angles_path: Path | str | None = None
    batch_size: int = 64
    device: Literal["cuda", "cpu"] = "cuda"
    latent_dim: int = 16
    random_seed: int = 42
    image_size: tuple[int, int] = (128, 128)
    top_n: int = 20
    orientation_threshold: float = 3.0


class DiffractionPatternIndexer:
    """Encodes patterns with a VAE, stores latents with their orientations
    in a database, and indexes unknown patterns against it.

    Args:
        model: the port's VAE; moved to ``config.device`` in eval mode.
        db: the database (a `TorchLatentVectorDatabase` of
            ``config.latent_dim`` on the same device when None).
        config: the indexer's configuration.
        timer: optional object whose ``phase(name)`` context times the
            encode and search phases of the query methods.
        mesh: optional `parallel.Mesh`: encode batches shard over its
            devices, each block encoded by that device's copy of the model
            (rows are independent through the conv stack, so the latents
            are the one-device build's to float roundoff).
            ``config.batch_size`` must divide by the mesh size, and
            ``config.device`` must be the mesh's first device.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        db: LatentVectorDatabaseBase | None = None,
        config: IndexerConfig | None = None,
        timer: Any | None = None,
        mesh: Any | None = None,
    ) -> None:
        self.timer = timer
        self.config = config if config is not None else IndexerConfig()
        self.mesh = mesh
        self.device = chunk_device(mesh, self.config.device, self.config.batch_size)
        self.db = (
            db
            if db is not None
            else TorchLatentVectorDatabase(
                LatentVectorDatabaseConfig(dimension=self.config.latent_dim), device=self.device
            )
        )
        self.model = model.to(self.device).eval()
        self._replicas = None if mesh is None else replicate(self.model, mesh)
        logger.info(f"Using device: {self.device}" if mesh is None else f"Using mesh: {mesh}")

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer is not None else contextlib.nullcontext()

    # -- encoding ----------------------------------------------------------

    @torch.inference_mode()
    def _dispatch_encode(self, batch: np.ndarray) -> tuple[torch.Tensor, int]:
        """Enqueue the encode of one ``(b <= batch_size, H, W, 1)`` chunk,
        padded to the batch size; returns the device ``mu`` and the number
        of real rows."""
        bs = self.config.batch_size
        n = len(batch)
        if n < bs:
            batch = np.concatenate([batch, np.zeros((bs - n,) + batch.shape[1:], batch.dtype)])
        batch = np.ascontiguousarray(batch, dtype=np.float32)
        if self.mesh is not None:
            blocks = shard_batch(batch, self.mesh)
            mu = [m.encode(x.permute(0, 3, 1, 2))[0] for m, x in zip(self._replicas, blocks)]
            return gather_rows(mu, self.mesh), n
        host = torch.from_numpy(batch)
        if self.device.type == "cuda":
            host = host.pin_memory()
        x = host.to(self.device, non_blocking=True).permute(0, 3, 1, 2)
        return self.model.encode(x)[0], n

    def _encode_fixed(self, batch: np.ndarray) -> np.ndarray:
        mu, n = self._dispatch_encode(batch)
        return mu[:n].cpu().numpy()

    def _to_nhwc(self, patterns) -> np.ndarray:
        """A ``(B, H, W, 1)`` float32 stack through the default transform,
        from one ``(H, W)`` or ``(H, W, 1)`` pattern or a ``(B, H, W)`` or
        ``(B, H, W, 1)`` stack."""
        x = np.asarray(patterns)
        if x.ndim == 2:
            x = default_transform(x, self.config.image_size)[None]
        elif x.ndim == 3:
            if x.shape[-1] == 1:
                x = default_transform(x[..., 0], self.config.image_size)[None]
            else:
                x = default_transform(x, self.config.image_size)
        elif x.ndim == 4:
            if x.shape[-1] != 1:
                raise ValueError(f"Expected NHWC with 1 channel, got {x.shape}")
            x = default_transform(x[..., 0], self.config.image_size)
        else:
            raise ValueError(f"Expected 2-4D pattern array, got {x.ndim}D")
        return x.astype(np.float32)

    def encode_pattern(self, pattern) -> np.ndarray:
        """The latent mean of one pattern."""
        return self._encode_fixed(self._to_nhwc(pattern)).squeeze()

    def encode_patterns_batch(self, patterns) -> np.ndarray:
        """Latent means of many patterns, ``batch_size`` at a time."""
        x = self._to_nhwc(patterns)
        bs = self.config.batch_size
        return np.vstack([self._encode_fixed(x[i : i + bs]) for i in range(0, len(x), bs)])

    # -- dictionary build --------------------------------------------------

    def build_dictionary(self, progress: bool = True) -> None:
        """Encode the configured dictionary stack and add it to the
        database. ``progress`` is accepted and draws nothing in the port."""
        logger.info(f"Generating latent vectors from patterns in {self.config.pattern_path}")
        latent_vectors, orientations = self._extract_latent_vectors_with_angles()
        logger.info(f"Adding {len(latent_vectors)} vectors to database")
        self.db.add_vectors(latent_vectors, orientations)

    def build_multiphase_dictionary(self, phase_sources, progress: bool = True) -> None:
        """Build a multi-phase dictionary from one ``(pattern_path,
        angles_path)`` pair per phase; a pair's list position is its phase
        id. Pair the database with a matching ``phase_symmetries``."""
        for phase_id, (pattern_path, angles_path) in enumerate(phase_sources):
            dm = self._make_datamodule(pattern_path, angles_path)
            latents, orientations = self._extract_latent_vectors_with_angles(dm)
            logger.info(f"Adding {len(latents)} phase-{phase_id} vectors to database")
            self.db.add_vectors(
                latents, orientations, phases=np.full(len(latents), phase_id, dtype=np.int32)
            )

    def _make_datamodule(self, pattern_path, angles_path) -> DPDataModule:
        if pattern_path is None or angles_path is None:
            raise ValueError("pattern_path and angles_path must be configured")
        dm = DPDataModule(
            path=pattern_path,
            rot_angles_path=angles_path,
            image_size=self.config.image_size,
            batch_size=self.config.batch_size,
        )
        dm.setup("test")
        return dm

    @cached_property
    def _datamodule(self) -> DPDataModule:
        """The configured dictionary's data module, in test mode."""
        return self._make_datamodule(self.config.pattern_path, self.config.angles_path)

    def _extract_latent_vectors_with_angles(
        self, dm: DPDataModule | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode every batch of the data module, up to `_WINDOW` in flight."""
        dm = dm if dm is not None else self._datamodule
        latents, orientations = [], []
        inflight: deque[tuple[torch.Tensor, int, np.ndarray]] = deque()

        def drain_one() -> None:
            mu, n, angles = inflight.popleft()
            latents.append(mu[:n].cpu().numpy())
            orientations.append(angles)

        for data, angles in dm.test_batches():
            mu, n = self._dispatch_encode(data)
            inflight.append((mu, n, np.asarray(angles)))
            if len(inflight) > _WINDOW:
                drain_one()
        while inflight:
            drain_one()
        return np.concatenate(latents, 0), np.concatenate(orientations, 0)

    def export_latents(
        self,
        latent_output_path: Path | str | None = None,
        angles_output_path: Path | str | None = None,
        progress: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode the dictionary stack and save (when paths are given) and
        return its latent means and orientations."""
        latents, orientations = self._extract_latent_vectors_with_angles()
        if latent_output_path is not None:
            np.save(Path(latent_output_path), latents)
            logger.info(f"Saved latent vectors to {latent_output_path}")
        if angles_output_path is not None:
            np.save(Path(angles_output_path), orientations)
            logger.info(f"Saved orientations to {angles_output_path}")
        return latents, orientations

    # -- querying ----------------------------------------------------------

    def index_pattern(
        self,
        pattern,
        top_n: int | None = None,
        orientation_threshold: float | None = None,
    ) -> OrientationResult:
        """The best orientation of one pattern."""
        top_n = top_n or self.config.top_n
        orientation_threshold = orientation_threshold or self.config.orientation_threshold
        with self._phase("encode"):
            latent_vector = self.encode_pattern(pattern)
        with self._phase("search"):
            return self.db.find_best_orientation(
                latent_vector, top_n=top_n, orientation_threshold=orientation_threshold
            )

    def index_patterns_batch(self, patterns, **kwargs) -> list[OrientationResult]:
        """The best orientations of many patterns."""
        kwargs.setdefault("top_n", self.config.top_n)
        kwargs.setdefault("orientation_threshold", self.config.orientation_threshold)
        with self._phase("encode"):
            latent_vectors = self.encode_patterns_batch(patterns)
        with self._phase("search"):
            return self.db.find_best_orientations_batch(
                latent_vectors, batch_size=self.config.batch_size, **kwargs
            )
