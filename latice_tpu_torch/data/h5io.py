"""HDF5 scan input: the container format real EBSD acquisitions ship in
(host numpy; the port's own copy of ``latice_tpu/data/h5io.py``).

The reference reads only ``.npy`` stacks (data_module.py:70-78), but vendor
EBSD files (H5EBSD family: EDAX, Bruker, Oxford ``.h5oina``) are HDF5 with
the pattern stack as one ``(N, H, W)`` dataset. This module adds first-class
HDF5 input without tying the framework to any one vendor schema:

* `find_pattern_dataset` auto-detects the pattern stack (the largest 3-D
  dataset with plausible pattern geometry) or takes an explicit dataset path;
* `iter_pattern_batches` streams slabs off disk without materializing the
  whole (potentially tens-of-GB) map in host memory, preserving uint8 —
  which then rides the pipeline's uint8 device path (4x less link traffic);
* `load_patterns` is the convenience whole-stack reader for small files.

Gated import: h5py is an optional dependency; every entry point raises a
clear error when it is missing.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "HDF5_EXTENSIONS",
    "find_pattern_dataset",
    "iter_pattern_batches",
    "load_patterns",
]

HDF5_EXTENSIONS = (".h5", ".hdf5", ".h5oina", ".oh5", ".hdf")

# Known H5EBSD-family pattern-stack locations, tried (by dataset-path suffix,
# case-insensitive) BEFORE the largest-3-D heuristic so a vendor file whose
# biggest 3-D dataset is a montage/EDS cube still resolves to the patterns.
# Order = priority when a file matches several.
VENDOR_PATTERN_SUFFIXES = (
    "ebsd/data/pattern",                # EDAX/TSL H5, e.g. "Scan 1/EBSD/Data/Pattern"
    "ebsd/data/rawpatterns",            # Bruker Esprit
    "ebsd/data/processed patterns",     # Oxford AZtec .h5oina
    "ebsd/data/unprocessed patterns",   # Oxford AZtec .h5oina (raw)
    "ebsd/data/patterns",               # kikuchipy h5ebsd
)


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "HDF5 scan input needs the optional dependency h5py "
            "(pip install h5py)"
        ) from e
    return h5py


def find_pattern_dataset(path: str, dataset: str | None = None):
    """Open ``path`` and return ``(file, dataset)`` for the pattern stack.

    With ``dataset`` given, that HDF5 path is used directly. Otherwise the
    known H5EBSD vendor locations (`VENDOR_PATTERN_SUFFIXES` — EDAX, Bruker,
    Oxford .h5oina, kikuchipy) are tried first; only when none match does the
    heuristic fall back to the largest 3-D dataset whose trailing two axes
    look like pattern geometry (>= 16 px). A warning is logged when several
    plausible candidates exist, since heuristic selection can mis-pick (e.g.
    a montage or EDS cube) — pass ``dataset`` explicitly to override.
    Caller owns closing the file.
    """
    h5py = _h5py()
    f = h5py.File(path, "r")
    try:
        if dataset is not None:
            if dataset not in f:
                raise KeyError(
                    f"dataset {dataset!r} not found in {path}; "
                    f"available: {_list_3d(f) or 'no 3-D datasets'}"
                )
            return f, f[dataset]
        candidates = _scan_3d(f)
        if not candidates:
            raise ValueError(f"no (N, H, W) pattern dataset found in {path}")

        for suffix in VENDOR_PATTERN_SUFFIXES:
            matches = [
                (n, d) for n, d in candidates if n.lower().endswith(suffix)
            ]
            if matches:
                name, dset = max(matches, key=lambda kv: kv[1].size)
                if len(matches) > 1:
                    logger.warning(
                        f"multiple datasets match vendor layout {suffix!r}; "
                        f"picked the largest, {name!r} {dset.shape} — pass "
                        "dataset= to override"
                    )
                logger.info(
                    f"vendor-schema pattern dataset {name!r} {dset.shape}"
                )
                return f, dset

        name, dset = max(candidates, key=lambda kv: kv[1].size)
        if len(candidates) > 1:
            logger.warning(
                f"no known vendor layout in {path}; {len(candidates)} "
                f"plausible 3-D datasets "
                f"({', '.join(n for n, _ in candidates)}) — picked the "
                f"largest, {name!r} {dset.shape}. Pass dataset= to override."
            )
        logger.info(f"auto-selected pattern dataset {name!r} {dset.shape}")
        return f, dset
    except Exception:
        f.close()
        raise


def _scan_3d(f) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []

    def visit(name, obj):
        if (
            hasattr(obj, "shape")
            and len(obj.shape) == 3
            and obj.shape[1] >= 16
            and obj.shape[2] >= 16
        ):
            out.append((name, obj))

    f.visititems(visit)
    return out


def _list_3d(f) -> str:
    return ", ".join(f"{n} {d.shape}" for n, d in _scan_3d(f))


def iter_pattern_batches(
    dset, batch_size: int = 4096
) -> Iterator[np.ndarray]:
    """Stream ``(<=batch_size, H, W)`` slabs; dtype preserved (uint8 stays
    uint8 for the device-side /255 path)."""
    n = dset.shape[0]
    for start in range(0, n, batch_size):
        yield np.asarray(dset[start : start + batch_size])


def load_patterns(path: str, dataset: str | None = None) -> np.ndarray:
    """Whole-stack read of the pattern dataset (small files / tests)."""
    f, dset = find_pattern_dataset(path, dataset)
    try:
        return np.asarray(dset[...])
    finally:
        f.close()
