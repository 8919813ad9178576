"""Batching of host pattern stacks, and the training data module.

The port of ``latice_tpu.data.datamodule`` (reference latice/data_module.py:
136-261). The whole preprocessed stack lives in host RAM as one array and
batches are slices of it. The seeded split and the per-epoch shuffle are
the JAX package's numpy code, so the port's batches are bit-identical to
its batches.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator

import numpy as np

from latice_tpu_torch.data.dataset import DPdataset

logger = logging.getLogger(__name__)

__all__ = ["DPDataModule", "batch_iterator", "pad_batch", "padded_batches"]


def padded_batches(x: np.ndarray, batch_size: int) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(n_real, chunk)`` with every chunk ``batch_size`` rows long.

    The last chunk is zero-padded; the caller trims results back to
    ``n_real``.
    """
    for start in range(0, len(x), batch_size):
        chunk = x[start : start + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = np.zeros((batch_size - n,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        yield n, chunk


def pad_batch(batch: np.ndarray, batch_size: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad a (possibly partial) batch to the static batch size.

    Returns ``(padded, mask, n_real)`` where ``mask`` is a float32 ``(B,)``
    row weight, 1 for real rows and 0 for pad rows. Every step then sees
    one batch shape, and the loss weighs the pad rows out.
    """
    n = len(batch)
    if n > batch_size:
        raise ValueError(f"Batch of {n} rows exceeds the static size {batch_size}")
    mask = np.zeros(batch_size, dtype=np.float32)
    mask[:n] = 1.0
    if n == batch_size:
        return batch, mask, n
    pad = np.zeros((batch_size - n,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, pad]), mask, n


def batch_iterator(
    arrays: tuple[np.ndarray, ...],
    batch_size: int,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_last: bool = False,
) -> Iterator[tuple[np.ndarray, ...]]:
    """Yield aligned batches from host arrays; ``drop_last=False`` keeps the
    final partial batch (the reference DataLoader default)."""
    n = len(arrays[0])
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        yield tuple(a[idx] for a in arrays)


class DPDataModule:
    """Train/val/test splits over a DPdataset with reference-default knobs."""

    def __init__(
        self,
        path: str | Path,
        rot_angles_path: str | Path,
        image_size: tuple[int, int] = (128, 128),
        val_data_ratio: float = 0.1,
        batch_size: int = 32,
        seed: int = 42,
        transform=None,
        n_cpu: int = 0,  # accepted for config parity; loading is vectorized
    ) -> None:
        self.path = path
        self.rot_angles_path = rot_angles_path
        self.image_size = tuple(image_size)
        self.val_data_ratio = val_data_ratio
        self.batch_size = batch_size
        self.seed = seed

        self.dataset_full = DPdataset(path, rot_angles_path, self.image_size, transform)
        self._train_idx: np.ndarray | None = None
        self._val_idx: np.ndarray | None = None
        self.dataset_test: DPdataset | None = None
        self._epoch_rng = np.random.default_rng(seed)

    def setup(self, stage: str | None = None) -> None:
        """Prepare splits for 'fit' or alias the full set for 'test'."""
        if stage == "fit" or stage is None:
            n = len(self.dataset_full)
            val_size = int(n * self.val_data_ratio)
            train_size = n - val_size
            logger.info(f"Splitting dataset: {train_size} training, {val_size} validation samples")
            perm = np.random.default_rng(self.seed).permutation(n)
            self._train_idx = np.sort(perm[:train_size])
            self._val_idx = np.sort(perm[train_size:])
        if stage == "test":
            self.dataset_test = self.dataset_full
            logger.info(f"Test dataset prepared with {len(self.dataset_test)} samples")

    @property
    def train_size(self) -> int:
        return 0 if self._train_idx is None else len(self._train_idx)

    @property
    def val_size(self) -> int:
        return 0 if self._val_idx is None else len(self._val_idx)

    def _subset(self, idx: np.ndarray | None) -> tuple[np.ndarray, np.ndarray]:
        ds = self.dataset_full
        if idx is None:
            raise RuntimeError("setup('fit') must be called first")
        return ds.patterns[idx], ds.rot_angles[idx]

    def train_batches(self, epoch: int | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled training batches; with a validation ratio of 0 the full
        set is used.

        With ``epoch`` given, the shuffle is seeded by ``(seed, epoch)``, so
        a resumed run replays the batch order of an uninterrupted one.
        Without it, a stateful stream is used.
        """
        idx = self._train_idx
        if self.val_data_ratio <= 0.0 and self._val_idx is not None:
            idx = np.concatenate([self._train_idx, self._val_idx])
        rng = np.random.default_rng((self.seed, epoch)) if epoch is not None else self._epoch_rng
        return batch_iterator(self._subset(idx), self.batch_size, shuffle=True, rng=rng)

    def val_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return batch_iterator(self._subset(self._val_idx), self.batch_size)

    def test_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if self.dataset_test is None:
            self.setup("test")
        ds = self.dataset_test
        return batch_iterator((ds.patterns, ds.rot_angles), self.batch_size)

    def num_train_batches(self) -> int:
        return -(-self.train_size // self.batch_size)

    def num_test_batches(self) -> int:
        return -(-len(self.dataset_full) // self.batch_size)
