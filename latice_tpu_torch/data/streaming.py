"""Streaming training data: `DPDataModule` semantics over out-of-core
pattern stores.

The port of ``latice_tpu.data.streaming``. `DPdataset` holds the whole
transformed stack in host RAM, which suits dictionary-sized sets; the
augmented and denoising trainer targets raw scans, which may not fit.
`StreamedDPDataModule` keeps the patterns in their container (an HDF5 scan
of any vendor layout `find_pattern_dataset` knows, an EDAX ``.up1``/``.up2``
memmap, or a memory-mapped ``.npy``) and reads each batch on demand, so host
residency is O(batch_size), independent of N.

The split and the shuffle are `DPDataModule`'s, bit for bit: the same
seeded permutation makes the split, and each epoch's shuffled order draws
from the RNG exactly as `batch_iterator` does, so a streamed run replays
the eager run's batches row for row. Each shuffled batch is fetched with
one sorted gather (HDF5 fancy indexing needs increasing indices) and put
back in order; the trainer's `prefetch_to_device` overlaps that host read
with the device's work.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator

import numpy as np

from latice_tpu_torch.data.dataset import parse_angle_file
from latice_tpu_torch.data.h5io import HDF5_EXTENSIONS, find_pattern_dataset
from latice_tpu_torch.data.transforms import default_transform
from latice_tpu_torch.data.up import UP_EXTENSIONS, open_up_patterns

logger = logging.getLogger(__name__)

__all__ = ["StreamedDPDataModule"]


class StreamedDPDataModule:
    """Train/val/test splits over an out-of-core pattern store.

    Drop-in for `DPDataModule` wherever the Trainer duck-types it
    (``setup`` / ``train_batches(epoch=)`` / ``val_batches`` /
    ``test_batches`` / ``num_train_batches`` / ``batch_size``) — only the
    storage differs: patterns stay in the container and stream per batch.

    Args:
        path: pattern store — ``.h5``/``.hdf5``/``.h5ebsd``/``.h5oina``
            (vendor dataset auto-detected, override with ``h5_dataset``),
            ``.up1``/``.up2`` (EDAX memmap), or ``.npy`` (opened with
            ``mmap_mode="r"`` — NOT loaded).
        rot_angles_path: angle file; optional here (raw scans trained for
            the denoising objective often have no labels yet) — absent
            angles yield zero triples, which the VAE loss never reads.
        image_size / val_data_ratio / batch_size / seed / transform:
            exactly `DPDataModule`'s knobs and semantics.
        h5_dataset: explicit HDF5 dataset path (see `find_pattern_dataset`).
    """

    def __init__(
        self,
        path: str | Path,
        rot_angles_path: str | Path | None = None,
        image_size: tuple[int, int] = (128, 128),
        val_data_ratio: float = 0.1,
        batch_size: int = 32,
        seed: int = 42,
        transform=None,
        h5_dataset: str | None = None,
        n_cpu: int = 0,  # config parity with DPDataModule
    ) -> None:
        self.path = str(path)
        self.image_size = tuple(image_size)
        self.val_data_ratio = val_data_ratio
        self.batch_size = batch_size
        self.seed = seed
        self._transform = transform
        self._file = None

        low = self.path.lower()
        if low.endswith(HDF5_EXTENSIONS):
            self._file, self._dset = find_pattern_dataset(
                self.path, h5_dataset
            )
        elif low.endswith(UP_EXTENSIONS):
            _, self._dset = open_up_patterns(self.path)
        elif low.endswith(".npy"):
            self._dset = np.load(self.path, mmap_mode="r")
        else:
            raise ValueError(
                "StreamedDPDataModule supports .h5/.hdf5/.h5ebsd/.h5oina, "
                f".up1/.up2 and .npy stores, got {self.path!r}"
            )
        if self._dset.ndim != 3:
            raise ValueError(
                f"expected a 3-D (N, H, W) pattern store, got shape "
                f"{self._dset.shape}"
            )
        n = len(self._dset)
        if rot_angles_path is not None:
            self.rot_angles = parse_angle_file(rot_angles_path)
            if len(self.rot_angles) != n:
                raise ValueError(
                    f"Pattern count {n} != angle count {len(self.rot_angles)}"
                )
        else:
            self.rot_angles = np.zeros((n, 3), np.float64)
        self._n = n
        self._train_idx: np.ndarray | None = None
        self._val_idx: np.ndarray | None = None
        self._epoch_rng = np.random.default_rng(seed)
        logger.info(f"Streaming dataset over {self.path}: {n} patterns")

    # -- storage ---------------------------------------------------------

    def close(self) -> None:
        """Release the underlying container (HDF5 handle / memmap)."""
        if self._file is not None:
            self._file.close()
            self._file = None
        self._dset = None

    def _read(self, rows: np.ndarray) -> np.ndarray:
        """Fetch + transform arbitrary rows: one sorted gather (HDF5 fancy
        indexing requires increasing, duplicate-free indices — shuffled
        batch rows are unique), order restored after."""
        srt = np.argsort(rows)
        raw = self._dset[rows[srt]]
        raw = np.asarray(raw)[np.argsort(srt)]
        if self._transform is None:
            return default_transform(raw, self.image_size)
        return np.stack([self._transform(p) for p in raw])

    def _batches(
        self, idx: np.ndarray, shuffle: bool = False,
        rng: np.random.Generator | None = None,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        # RNG consumption mirrors `batch_iterator` exactly (shuffle an
        # arange over the SUBSET) so the streamed batch order replays the
        # eager module's bit for bit — including the lazy first-next
        # semantics the Trainer's first-batch peek relies on.
        order = np.arange(len(idx))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, len(idx), self.batch_size):
            rows = idx[order[start : start + self.batch_size]]
            yield self._read(rows), self.rot_angles[rows]

    # -- DPDataModule surface --------------------------------------------

    def setup(self, stage: str | None = None) -> None:
        if stage == "fit" or stage is None:
            val_size = int(self._n * self.val_data_ratio)
            train_size = self._n - val_size
            logger.info(
                f"Splitting dataset: {train_size} training, "
                f"{val_size} validation samples"
            )
            perm = np.random.default_rng(self.seed).permutation(self._n)
            self._train_idx = np.sort(perm[:train_size])
            self._val_idx = np.sort(perm[train_size:])
        # 'test' needs no preparation: test_batches streams the full store.

    @property
    def train_size(self) -> int:
        return 0 if self._train_idx is None else len(self._train_idx)

    @property
    def val_size(self) -> int:
        return 0 if self._val_idx is None else len(self._val_idx)

    def _require_split(self, idx: np.ndarray | None) -> np.ndarray:
        if idx is None:
            raise RuntimeError("setup('fit') must be called first")
        return idx

    def train_batches(
        self, epoch: int | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = self._require_split(self._train_idx)
        if self.val_data_ratio <= 0.0 and self._val_idx is not None:
            idx = np.concatenate([self._train_idx, self._val_idx])
        rng = (
            np.random.default_rng((self.seed, epoch))
            if epoch is not None
            else self._epoch_rng
        )
        return self._batches(idx, shuffle=True, rng=rng)

    def val_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self._batches(self._require_split(self._val_idx))

    def test_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self._batches(np.arange(self._n))

    def num_train_batches(self) -> int:
        return -(-self.train_size // self.batch_size)

    def num_test_batches(self) -> int:
        return -(-self._n // self.batch_size)
