"""EDAX UP1/UP2 raw pattern files: the TSL binary scan format (host numpy;
the port's own copy of ``latice_tpu/data/up.py``).

EDAX/TSL acquisition software stores raw detector frames as a single
``.up1`` (8-bit) or ``.up2`` (16-bit) binary file next to the ``.ang`` scan.
The reference reads only ``.npy`` stacks (data_module.py:70-78); this module
lets those vendor files stream straight into ``index.py query`` with zero
conversion, the same way HDF5 scans do (data/h5io.py):

* `read_up_header` parses the little-endian header (version 1 and the
  version >= 3 layout with scan geometry: columns, rows, hex flag, steps);
* `open_up_patterns` maps the pattern block as a read-only ``np.memmap`` —
  the scan never copies into host RAM, and uint8 (``.up1``) slabs ride the
  pipeline's device-side /255 fast path (4x less link traffic on tunneled
  rigs; ROADMAP uint8 row). ``.up2`` frames are uint16, which
  `transforms.prepare_patterns` normalizes by dtype max on host;
* `iter_up_batches` / `load_up_patterns` mirror the h5io streaming API.

Header layout (all little-endian; field offsets in bytes):

======= ======================= =====================================
offset  field                   notes
======= ======================= =====================================
0       uint32 version          1, or >= 3 (modern TSL writers)
4       uint32 pattern_width    px
8       uint32 pattern_height   px
12      uint32 data_offset      byte offset of the first pattern
--- version >= 3 only ---
16      uint8  extra_patterns   hex grids store one extra frame/odd row
17      uint32 n_columns        scan grid columns
21      uint32 n_rows           scan grid rows
25      uint8  hexagonal        1 = hex grid, 0 = square
26      float64 x_step          um
34      float64 y_step          um
======= ======================= =====================================

Pattern count is derived from the file size (``(size - offset) // frame``),
which is correct for both layouts including hex scans with extra frames
(frames are stored contiguously either way). Unknown versions fall back to
the ``data_offset`` field, which is authoritative in every layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import struct
from typing import Iterator

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "UP_EXTENSIONS",
    "UpHeader",
    "read_up_header",
    "open_up_patterns",
    "iter_up_batches",
    "load_up_patterns",
]

UP_EXTENSIONS = (".up1", ".up2")

#: Byte length of the version >= 3 header (through y_step).
_V3_HEADER_BYTES = 42


@dataclasses.dataclass(frozen=True)
class UpHeader:
    """Parsed UP1/UP2 header plus derived geometry."""

    version: int
    pattern_width: int
    pattern_height: int
    data_offset: int
    dtype: np.dtype
    n_patterns: int
    #: Scan geometry, present only in version >= 3 headers.
    n_columns: int | None = None
    n_rows: int | None = None
    hexagonal: bool | None = None
    extra_patterns: bool | None = None
    x_step: float | None = None
    y_step: float | None = None

    @property
    def scan_grid(self) -> tuple[int, int] | None:
        """(rows, cols) when the header carries a usable square scan grid.

        Hex grids interleave rows of different lengths, so a rectangular
        (rows, cols) reshape would misalign them — those return None and the
        caller must supply the geometry explicitly.
        """
        if self.n_rows and self.n_columns and self.hexagonal is False:
            if self.n_rows * self.n_columns == self.n_patterns:
                return (self.n_rows, self.n_columns)
        return None


def _dtype_for(path: str) -> np.dtype:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".up1":
        return np.dtype("<u1")
    if ext == ".up2":
        return np.dtype("<u2")
    raise ValueError(
        f"not an EDAX UP pattern file (expected {UP_EXTENSIONS}): {path}"
    )


def read_up_header(path: str) -> UpHeader:
    """Parse the header of an EDAX ``.up1``/``.up2`` file."""
    dtype = _dtype_for(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(_V3_HEADER_BYTES)
    if len(head) < 16:
        raise ValueError(f"{path}: truncated UP header ({len(head)} bytes)")
    version, width, height, offset = struct.unpack_from("<4I", head, 0)
    extra: dict = {}
    if version >= 3 and len(head) >= _V3_HEADER_BYTES:
        extra_flag, n_cols = struct.unpack_from("<BI", head, 16)
        n_rows, hex_flag = struct.unpack_from("<IB", head, 21)
        x_step, y_step = struct.unpack_from("<2d", head, 26)
        extra = dict(
            extra_patterns=bool(extra_flag),
            n_columns=int(n_cols),
            n_rows=int(n_rows),
            hexagonal=bool(hex_flag),
            x_step=float(x_step),
            y_step=float(y_step),
        )
    elif version not in (1,):
        # Unknown layout: the data_offset field is still authoritative.
        logger.warning(
            f"{path}: unknown UP version {version}; trusting the header's "
            f"data offset ({offset})"
        )
    if width < 1 or height < 1:
        raise ValueError(f"{path}: bad pattern geometry {width}x{height}")
    if not 16 <= offset <= size:
        raise ValueError(
            f"{path}: data offset {offset} outside the file ({size} bytes)"
        )
    frame = width * height * dtype.itemsize
    n_patterns, rem = divmod(size - offset, frame)
    if rem:
        logger.warning(
            f"{path}: {rem} trailing bytes after {n_patterns} whole "
            f"{width}x{height} frames — file may be truncated"
        )
    if n_patterns < 1:
        raise ValueError(f"{path}: no complete patterns after the header")
    return UpHeader(
        version=int(version),
        pattern_width=int(width),
        pattern_height=int(height),
        data_offset=int(offset),
        dtype=dtype,
        n_patterns=int(n_patterns),
        **extra,
    )


def open_up_patterns(path: str) -> tuple[UpHeader, np.ndarray]:
    """Map the pattern block of a UP file as a read-only ``(N, H, W)`` memmap.

    Nothing is read until slices are taken, so arbitrarily large scans
    stream through `iter_up_batches` without materializing in host memory.
    """
    header = read_up_header(path)
    patterns = np.memmap(
        path,
        dtype=header.dtype,
        mode="r",
        offset=header.data_offset,
        shape=(
            header.n_patterns,
            header.pattern_height,
            header.pattern_width,
        ),
    )
    return header, patterns


def iter_up_batches(
    patterns: np.ndarray, batch_size: int = 4096
) -> Iterator[np.ndarray]:
    """Stream ``(<=batch_size, H, W)`` slabs off the memmap; dtype preserved
    (uint8 ``.up1`` slabs keep the device-side /255 path)."""
    n = len(patterns)
    for start in range(0, n, batch_size):
        # np.asarray(...) of a memmap slice copies just the slab off disk.
        yield np.asarray(patterns[start : start + batch_size])


def load_up_patterns(path: str) -> np.ndarray:
    """Whole-stack read of a UP file (small files / tests)."""
    _, patterns = open_up_patterns(path)
    return np.asarray(patterns[...])
